"""The Mamba2 chunked scan's share of its roofline over the traced
prefills, in %: the larger of the scans' FLOPs at 165 TFLOP/s and their
bytes at 3.35 TB/s (``harness/ssd_flops.py``, for the tokens times layers
the program's counter ``ssd.tokens`` gives), over the device time of the
program's ``ssd`` spans. None where the program records no such span or
counter. Moves ``prefill_tokens_per_s``."""

from harness import program_spans, ssd_flops


def read(ctx):
    if ctx.kind != "prefill" or not hasattr(ctx.spec, "ssm_heads"):
        return None
    got = program_spans.recorded()
    if got is None or not got[1].get("ssd.tokens"):
        return None
    recs, counts = got
    spans = [r.device_ns for r in recs if r.name == "ssd"]
    if not spans or None in spans:
        return None
    spent = sum(b - a for a, b in spans) / 1e9
    return 100.0 * ssd_flops.bound_s(ctx.spec, counts["ssd.tokens"]) / spent
