"""``temporal_ms.*``: the program's span ``ococcnet.temporal`` (the position
encoding, the temporal transformer, the latent and RCNN heads) per traced
call, in ms of stream time from its entry event to its exit event
(``portbench/spans.py``); idle time inside the span counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "ococcnet.temporal"


def read(ctx):
    return span_ms("ococcnet.temporal", ctx)
