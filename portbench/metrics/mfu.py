"""``mfu.*``: the operations the inputs need (``portbench/counts.py``) over
the untraced window's time, as a share of the card's float32-accurate peak
(three TF32 products, 494.7 / 3 TFLOP/s), in %."""
import torch

from portbench.counts import PEAK_FLOPS


def read(ctx):
    if ctx.device.type != "cuda" or ctx.flops_per_s <= 0:
        return None
    return 100.0 * ctx.flops_per_s / PEAK_FLOPS[torch.float32]
