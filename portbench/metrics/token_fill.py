"""``token_fill.*``: the voxels the program lays into windows over the
window slots its attention layers run, summed over the layers and both
levels (``sst.tokens`` / ``sst.token_slots``, counted on each layer's
level masks: the true entries and the windows x capacity), in %."""
from portbench.spans import fill

# the program counters this reads: (useful, slots)
SOURCE = ("sst.tokens", "sst.token_slots")


def read(ctx):
    return fill("sst.tokens", "sst.token_slots")
