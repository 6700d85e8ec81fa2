"""Device kernels launched a training step over the traced steps (copies
and fills not counted). Moves ``train_tokens_per_s``."""


def read(ctx):
    if ctx.kind != "train" or ctx.reading is None or not ctx.steps \
            or not ctx.reading.kernels:
        return None
    return len(ctx.reading.kernels) / ctx.steps
