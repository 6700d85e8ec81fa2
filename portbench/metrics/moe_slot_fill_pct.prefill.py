"""The share of the experts' capacity slots that kept assignments fill,
in %: the program's ``moe.slots_filled`` counter over ``moe.slots``
(experts × capacity of every dispatch) over the traced prefills; the
rest of each expert batch is padding the expert GEMMs compute. Moves
``ttft_p90_ms``."""

from harness import program_spans


def read(ctx):
    if ctx.kind != "prefill":
        return None
    got = program_spans.recorded()
    if got is None or not got[1].get("moe.slots"):
        return None
    counts = got[1]
    return 100.0 * counts.get("moe.slots_filled", 0) / counts["moe.slots"]
