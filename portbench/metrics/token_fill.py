"""``token_fill.*``: the voxels the program lays into windows over the
window slots its attention layers run, summed over the layers and both
levels (``sst.tokens`` / ``sst.token_slots``, counted at each layer's
``flat_to_window``), in %."""
from portbench.spans import fill


def read(ctx):
    return fill("sst.tokens", "sst.token_slots")
