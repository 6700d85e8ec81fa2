"""The share of the card's float32 peak (165 TFLOP/s) that the traced
training steps' model FLOPs (three forwards of the tokens trained) took
over the traced stretch, in %. Moves ``train_tokens_per_s``."""

from harness import flops


def read(ctx):
    if ctx.kind != "train" or ctx.reading is None or not ctx.steps:
        return None
    work = ctx.steps * flops.train_step_flops(ctx.spec, ctx.batch,
                                              ctx.seq_len)
    return 100.0 * work / (ctx.reading.window_s * flops.F32_PEAK_FLOPS)
