"""Kernel B4's share of its roofline over the traced prefills, in %: the
sum over its launches of the larger of their FLOPs at 165 TFLOP/s and
their bytes at 3.35 TB/s, over B4's device time (its kernel found by
name). A launch the profiler failed to record is counted at the mean time
of those it recorded. Moves ``prefill_tokens_per_s``."""

from harness import flops

KERNEL = "fa_forward_kernel"


def read(ctx):
    if ctx.kind != "prefill" or ctx.reading is None or not ctx.prompts:
        return None
    times = [s for name, s in ctx.reading.kernels if KERNEL in name]
    if not times:
        return None
    launches = ctx.spec.layers * len(ctx.prompts)
    bound = sum(ctx.spec.layers * flops.b4_bound_s(ctx.spec, n)
                for n in ctx.prompts)
    spent = sum(times) / len(times) * max(launches, len(times))
    return 100.0 * bound / spent
