"""``forward_ms.*``: the program's span ``train.forward`` (the training
step's forward and losses) per traced call, in ms of stream time from its
entry event to its exit event (``portbench/spans.py``); idle time inside the
span counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "train.forward"


def read(ctx):
    return span_ms("train.forward", ctx)
