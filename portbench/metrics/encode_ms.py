"""``encode_ms.*``: the program's span ``ococcnet.encode`` (both SIR
encoders) per traced call, in ms of stream time from its entry event to its
exit event (``portbench/spans.py``); idle time inside the span counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "ococcnet.encode"


def read(ctx):
    return span_ms("ococcnet.encode", ctx)
