"""K1's (ops/spmm_tiled.py -> csrc/spmm_tiled.cu) share of its roofline
over the traced epoch: the least time of every K1 launch of every step
(the config's schedule, counts/<config>.py: k1_launches; the bytes each
launch needs at the batch's real rows, harness/costs.py: k1_bound_s) over
the device time of the kernels named spmm_tiled_kernel."""


def read(ctx):
    t = ctx.trace
    launches = ctx.counts.k1_launches(ctx.cfg)
    device = 0.0 if t is None else t.seconds("spmm_tiled_kernel<")
    if not launches or device <= 0:
        return None
    bound = sum(ctx.costs.k1_bound_s(feat, transposed, ctx.slots, real)
                for real in t.steps.real for feat, transposed in launches)
    return 100.0 * bound / device
