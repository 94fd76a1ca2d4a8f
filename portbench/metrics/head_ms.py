"""``head_ms.*``: the program's span ``sst.head`` (the anchor head and its
decode) per traced call, in ms of stream time from its entry event to its
exit event (``portbench/spans.py``); idle time inside the span counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "sst.head"


def read(ctx):
    return span_ms("sst.head", ctx)
