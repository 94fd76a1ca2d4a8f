"""``launches.*``: device kernels, copies and sets per traced call (per
training step), counted in the trace."""


def read(ctx):
    if not ctx.device_events:
        return None
    return len(ctx.device_events) / ctx.calls
