"""The share of the traced stretch in which nothing ran on the card, in %:
one less the union of device operations over the stretch. Moves
``prefill_tokens_per_s``."""


def read(ctx):
    if ctx.kind != "prefill" or ctx.reading is None:
        return None
    return 100.0 * (1.0 - ctx.reading.busy_s / ctx.reading.window_s)
