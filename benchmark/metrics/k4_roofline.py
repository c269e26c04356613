"""K4's (ops/gatedgcn_gate.py -> csrc/gatedgcn_gate.cu) share of its
roofline over the traced epoch: the least time of every K4 launch of every
step (counts/<config>.py: k4_launches; harness/costs.py: k4_bound_s) over
the device time of the kernels named gate_kernel."""


def read(ctx):
    t = ctx.trace
    launches = ctx.counts.k4_launches(ctx.cfg)
    device = 0.0 if t is None else t.seconds("gate_kernel<")
    if not launches or device <= 0:
        return None
    bound = sum(ctx.costs.k4_bound_s(feat, ctx.slots, real)
                for real in t.steps.real for feat in launches)
    return 100.0 * bound / device
