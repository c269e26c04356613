"""Share of the window the training loop spends blocked in the input
pipeline's next() (data/batcher.py), on the host's clock: the epoch-start
packing stall and any batch the producer thread had not ready."""


def read(ctx):
    return 100.0 * ctx.window.wait_s / ctx.window.seconds
