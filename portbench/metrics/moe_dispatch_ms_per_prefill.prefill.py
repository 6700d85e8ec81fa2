"""Device ms of the MoE dispatch a traced prefill: the device intervals
of the program's ``moe.route``, ``moe.dispatch`` and ``moe.combine``
spans (router, sort, counts, ranks, scatter into expert batches, gated
combine; not the experts' products) inside each ``serve.prefill`` span,
summed, averaged over the traced prefills. Moves ``ttft_p90_ms``."""

from harness import program_spans


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return program_spans.mean_device_ms(
        "serve.prefill", {"moe.route", "moe.dispatch", "moe.combine"})
