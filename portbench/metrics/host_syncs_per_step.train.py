"""Host-device syncs a traced training step: the program's
``host_syncs`` counter over the ``train.step`` spans. Moves
``train_tokens_per_s``."""

from harness import program_spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return program_spans.per_span("host_syncs", "train.step")
