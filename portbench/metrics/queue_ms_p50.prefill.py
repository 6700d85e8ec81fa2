"""The median wait of a prefill request, in ms: from the moment it was due
to be sent to the start of ``Model.prefill`` (a harness span around
``ContinuousBatcher.admit``), over the requests of the traced stretch
(the profiler's stop, which takes seconds, queues those after it).
Moves ``ttft_p90_ms``."""

import statistics


def read(ctx):
    if ctx.kind != "prefill" or not ctx.queue_ms:
        return None
    return statistics.median(ctx.queue_ms)
