"""``occ_decoder_ms.*``: the program's span ``ococcnet.occ_decoder`` (the
implicit occupancy decoder) per traced call, in ms of stream time from its
entry event to its exit event (``portbench/spans.py``); idle time inside the
span counts."""
from portbench.spans import span_ms

# the program span this reads
SOURCE = "ococcnet.occ_decoder"


def read(ctx):
    return span_ms("ococcnet.occ_decoder", ctx)
