"""``h2d_ms.*``: the program's span ``train.h2d`` (the training step's copy
of its batch to the card) per traced call, in ms of stream time from its
entry event to its exit event (``portbench/spans.py``); idle time inside the
span counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "train.h2d"


def read(ctx):
    return span_ms("train.h2d", ctx)
