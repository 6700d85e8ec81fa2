"""Device ms of the Mamba2 mixers a traced prefill: the device intervals
of the program's ``mamba`` spans (each mixer's norm, in-projection, conv,
chunked scan, gated norm, out-projection and residual) inside each
``serve.prefill`` span, summed, averaged over the traced prefills. None
where the program records no such span. Moves ``prefill_tokens_per_s``."""

from harness import program_spans


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return program_spans.mean_device_ms("serve.prefill", {"mamba"})
