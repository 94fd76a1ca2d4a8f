"""``blocks_ms.*``: the program's span ``sst.blocks`` (the window
partitions, the 12 attention layers and the BEV canvas) per traced call, in
ms of stream time from its entry event to its exit event
(``portbench/spans.py``); idle time inside the span counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "sst.blocks"


def read(ctx):
    return span_ms("sst.blocks", ctx)
