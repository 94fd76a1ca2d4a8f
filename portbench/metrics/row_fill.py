"""``row_fill.*``: the valid voxels that the program's SST blocks run their
per-token operations (projections, FFN, LayerNorms) on, over the rows they
run them on, summed over the layers (``sst.rows`` / ``sst.row_slots``:
``max_voxels`` rows a layer), in %."""
from portbench.spans import fill

# the program counters this reads: (useful, slots)
SOURCE = ("sst.rows", "sst.row_slots")


def read(ctx):
    return fill("sst.rows", "sst.row_slots")
