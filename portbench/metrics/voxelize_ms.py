"""``voxelize_ms.*``: the program's span ``sst.voxelize`` (voxelization, the
VFE and the input projection) per traced call, in ms of stream time from its
entry event to its exit event (``portbench/spans.py``); idle time inside the
span counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "sst.voxelize"


def read(ctx):
    return span_ms("sst.voxelize", ctx)
