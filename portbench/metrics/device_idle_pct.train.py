"""The share of the traced training steps' stretch in which nothing ran
on the card, in %. Moves ``train_tokens_per_s``."""


def read(ctx):
    if ctx.kind != "train" or ctx.reading is None:
        return None
    return 100.0 * (1.0 - ctx.reading.busy_s / ctx.reading.window_s)
