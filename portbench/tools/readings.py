"""The readings the limits of a cell's check are set from, on the card.

    python3 portbench/tools/readings.py --workload <cell> --seeds 11,12,13 \
        [--seconds 12] [--dtype bfloat16] [--fault half_batch] \
        [--mix rate=3.5]

Runs the cell's driver at the cell's own size once for each seed, in one
process, with a short window (``--seconds``; a training cell's readings
need none), and prints each run's compared numbers as one JSON line. The
program as the cells run it gives the lower readings; ``--dtype
bfloat16`` builds it in bf16, the control, and ``--fault`` plants one of
the faults the tests plant (``harness.prefill``, ``harness.train``).
``--mix rate=<r>`` sends at another rate: the sweep that finds the rate a
prefill cell sustains. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE),
                os.path.join(os.path.dirname(os.path.dirname(HERE)), "src")]

from harness import main as hm  # noqa: E402


def run(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--fault", default=None,
                    choices=("unchanged", "half_batch", "answer"))
    ap.add_argument("--mix", action="append", default=[],
                    help="key=value (JSON) set in the traffic mix, as a "
                         "sweep of rates does")
    args = ap.parse_args(argv)
    p = hm.parts(hm.manifest(), args.workload)
    for kv in args.mix:
        key, value = kv.split("=", 1)
        p.mix[key] = json.loads(value)
    hm.set_environment(p.mix["kind"])
    import importlib

    import torch

    from harness.trace import Tracer

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(p.driver)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = driver.run(p.conf, p.mix, seed, args.seconds, Tracer(False),
                         "cuda", t, dtype=getattr(torch, args.dtype),
                         fault=args.fault)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "dtype": args.dtype,
            "fault": args.fault, "mix": args.mix, "checks": out.checks,
            "attempted": out.attempted, "failed": out.failed,
            "e2e": out.e2e, "notes": out.notes,
            "memory_peak_bytes": out.memory_peak,
            "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
