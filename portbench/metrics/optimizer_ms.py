"""``optimizer_ms.*``: the program's span ``train.optimizer`` (the
gradients' reduction, norm and clip, and AdamW's update) per traced call, in
ms of stream time from its entry event to its exit event
(``portbench/spans.py``); idle time inside the span counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "train.optimizer"


def read(ctx):
    return span_ms("train.optimizer", ctx)
