"""``neck_ms.*``: the program's span ``sst.neck`` (the dilated convolutions
and GroupNorms) per traced call, in ms of stream time from its entry event
to its exit event (``portbench/spans.py``); idle time inside the span
counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "sst.neck"


def read(ctx):
    return span_ms("sst.neck", ctx)
