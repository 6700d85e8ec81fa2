"""The readings the limits of ``granite-4.0-h-small.prefill-long``'s check
are set from, on the card, without the cell's window.

    python3 portbench/tools/readings_hybrid.py --seeds 11,12,13 \
        [--prompts 3] [--dtype bfloat16] [--fault half_batch]

For each seed, in one process: the weights drawn as the cell draws them,
the program built from them (in ``--dtype``, the control, or with
``--fault`` planted as ``harness.prefill.Tap`` plants it), then
``--prompts`` prompts served through ``ContinuousBatcher.admit`` as the
cell serves them (the longest length the mix sends, then the seed's first
lengths in the mix's order) and compared by ``harness.hybrid_prefill
.check``. Prints each seed's compared numbers as one JSON line. The
benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE),
                os.path.join(os.path.dirname(os.path.dirname(HERE)), "src")]

from harness import main as hm  # noqa: E402

CELL = "granite-4.0-h-small.prefill-long"


def run(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--prompts", type=int, default=3)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--fault", default=None,
                    choices=("unchanged", "half_batch", "answer"))
    args = ap.parse_args(argv)
    p = hm.parts(hm.manifest(), CELL)
    hm.set_environment(p.mix["kind"])
    import torch

    from harness import hybrid_prefill as hp
    from harness import traffic
    from harness.prefill import Tap
    from harness.trace import Tracer
    from repro_torch.serve.batching import ContinuousBatcher, Request

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf, mix = p.conf, p.mix
    spec = hp.spec_of(conf)
    dtype = getattr(torch, args.dtype)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        weights = hp.make_weights(spec, seed, "cuda", conf.get("init"))
        model = hp.port_model(hp.meta_model(conf),
                              hp.as_dtype(weights, dtype))
        tap = Tap(model, Tracer(False), args.fault)
        batcher = ContinuousBatcher(tap, max_slots=mix["max_slots"])
        if args.fault == "answer":
            greedy = batcher._greedy
            batcher._greedy = lambda lg, g=greedy: (g(lg) + 1) % spec.vocab
        order = traffic.PromptLengths(mix, seed)
        lengths = [int(traffic.distinct_lengths(mix)[0])] + [
            order[i] for i in range(1, args.prompts)]
        kept = []
        for uid, n in enumerate(lengths):
            s = traffic.Sent(uid, n, time.perf_counter())
            req = Request(uid=uid, prompt=traffic.prompt_tokens(
                seed, uid, n, spec.vocab), max_new_tokens=1)
            batcher.cache_len = traffic.cache_len(mix, n)
            tap.sent = s
            batcher.admit(req)
            s.token = int(req.out_tokens[0])
            kept.append((s, *tap.last))
            tap.last = None
        del batcher, tap, model
        gc.collect()
        torch.cuda.empty_cache()
        checks, notes = hp.check(spec, weights, kept, seed)
        print(json.dumps({
            "workload": CELL, "seed": seed, "dtype": args.dtype,
            "fault": args.fault, "lengths": lengths, "checks": checks,
            "notes": notes, "wall_s": time.perf_counter() - t}), flush=True)
        del kept, weights
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
