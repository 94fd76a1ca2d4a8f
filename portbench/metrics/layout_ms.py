"""``layout_ms.*``: the program's span ``ococcnet.layout`` (the RoI pool and
the point packing) per traced call, in ms of stream time from its entry
event to its exit event (``portbench/spans.py``); idle time inside the span
counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "ococcnet.layout"


def read(ctx):
    return span_ms("ococcnet.layout", ctx)
