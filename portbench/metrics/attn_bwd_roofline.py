"""``attn_bwd_roofline``: over the traced training steps, the attention
backward kernels' least time (``counts.attention_bound_ms`` with
``backward=True`` on the level masks of each layer that the reference's own
windowing finds) over the device time of the kernels whose name holds
``window_attention_bwd``, in %. A kernel that replaces them has to keep
that substring in its name, or this reads nothing."""

KERNEL = "window_attention_bwd"


def read(ctx):
    bound_s = ctx.extra.get("attn_bwd_bound_s")
    kernel_s = sum(e - s for s, e, n in ctx.device_events
                   if KERNEL in n) * 1e-6
    if not bound_s or kernel_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s
