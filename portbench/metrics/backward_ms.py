"""``backward_ms.*``: the program's span ``train.backward`` (the training
step's backward) per traced call, in ms of stream time from its entry event
to its exit event (``portbench/spans.py``); idle time inside the span
counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "train.backward"


def read(ctx):
    return span_ms("train.backward", ctx)
