"""Share of the traced epoch's device time in kernels named reduce_kernel:
mostly the masked BatchNorm's statistics (nn/norm.py) and the sums of the
dense blocks (nn/mlp.py)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.device_s <= 0:
        return None
    return 100.0 * t.seconds("reduce_kernel") / t.device_s
