"""``idle_share.*``: the share of the untraced window in which no kernel,
copy or set ran on the card, in %: 1 - (device busy time per traced call:
the union of the trace's device intervals over the calls) / (the untraced
window's wall per call). The profiler slows the host, which it records
operator by operator, so the traced wall would overstate the idle share;
the busy time is the card's own. The traced calls are one whole pass over
the mix's pool, the mix the window runs."""


def read(ctx):
    if not ctx.device_events or ctx.wall_per_call <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.calls / ctx.wall_per_call)
