"""Device ms of attention a traced prefill: the device intervals of the
program's ``attn`` spans (each self-attention: norm, projections, rope
and its sync, B4, the cache writes, the output projection) inside each
``serve.prefill`` span, summed, averaged over the traced prefills. Moves
``prefill_tokens_per_s``."""

from harness import program_spans


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return program_spans.mean_device_ms("serve.prefill", {"attn"})
