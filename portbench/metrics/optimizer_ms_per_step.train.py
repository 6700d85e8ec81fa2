"""Device ms of the optimizer a traced training step: the device
interval of the program's ``train.optimizer`` span (gradient clipping and
AdamW over every leaf) inside each ``train.step`` span, averaged over the
traced steps. Moves ``train_tokens_per_s``."""

from harness import program_spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return program_spans.mean_device_ms("train.step", {"train.optimizer"})
