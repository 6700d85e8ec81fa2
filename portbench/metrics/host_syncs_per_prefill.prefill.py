"""Host-device syncs a traced prefill: the program's ``host_syncs``
counter (one a ``sync.*`` span: the prompt's upload, rope's table, the
MoE counts, the greedy pick) over the ``serve.prefill`` spans. Moves
``prefill_tokens_per_s``."""

from harness import program_spans


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return program_spans.per_span("host_syncs", "serve.prefill")
