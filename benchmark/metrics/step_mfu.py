"""The whole step's share of the card's float32 peak (67 TFLOP/s): the
analytic FLOPs of every step of the window (forward, backward and Adam, at
each batch's real nodes, edges and graphs: counts/<config>.py) over the
window's seconds.  It bounds every kernel's roofline share from above in
what it can gain end to end."""


def read(ctx):
    flops = sum(ctx.counts.step_flops(ctx.cfg, real, ctx.params)
                for real in ctx.window.real)
    return 100.0 * flops / ctx.window.seconds / ctx.costs.PEAK_F32_FLOPS
