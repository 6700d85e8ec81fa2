"""The share of the card's float32 peak (165 TFLOP/s, three TF32 passes)
that the traced prefills' model FLOPs took over the traced stretch, in %.
Moves ``prefill_tokens_per_s``."""

from harness import flops


def read(ctx):
    if ctx.kind != "prefill" or ctx.reading is None or not ctx.prompts:
        return None
    work = sum(flops.prefill_flops(ctx.spec, n) for n in ctx.prompts)
    return 100.0 * work / (ctx.reading.window_s * flops.F32_PEAK_FLOPS)
