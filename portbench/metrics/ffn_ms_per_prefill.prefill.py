"""Device ms of the feed-forward a traced prefill: the device intervals
of the program's ``ffn`` spans (each layer's SwiGLU or MoE with its norm
and residual) inside each ``serve.prefill`` span, summed, averaged over
the traced prefills. Moves ``prefill_tokens_per_s``."""

from harness import program_spans


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return program_spans.mean_device_ms("serve.prefill", {"ffn"})
