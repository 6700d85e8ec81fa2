"""Serving example: continuous batching with prefill + KV-cache decode.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

The port of ``examples/serve_decode.py``: the smoke smollm-135m, every
prefill through kernel B4 on the card.
"""

import argparse

from repro_torch.launch.serve import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    reqs, stats = run("smollm-135m", smoke=True, n_requests=8, max_new=16,
                      max_slots=4, cache_len=96, device=args.device)
    print(f"prefills={stats.prefills} decode_steps={stats.decode_steps} "
          f"tokens={stats.emitted_tokens}")
    for r in reqs[:3]:
        print(f"  req {r.uid}: prompt[:6]={r.prompt[:6].tolist()} → "
              f"out={r.out_tokens}")


if __name__ == "__main__":
    main()
