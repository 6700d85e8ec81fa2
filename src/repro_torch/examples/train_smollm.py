"""End to end: dedup → train a reduced smollm with checkpointing.

    PYTHONPATH=src python -m repro_torch.examples.train_smollm \\
        [--steps 200] [--ckpt-dir D] [--device cpu]

The port of ``examples/train_smollm.py``. The checkpoints go under the
temporary directory unless ``--ckpt-dir`` names another.
"""

import argparse
import os
import tempfile

from repro_torch.launch.train import run, set_cublas_workspace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_smollm"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    set_cublas_workspace()
    out = run("smollm-135m", smoke=True, steps=args.steps,
              ckpt_dir=args.ckpt_dir, resume=False, fail_at=None,
              seq_len=128, global_batch=8, ckpt_every=50, dedup=True,
              log_every=10, device=args.device)
    losses = out["losses"]
    print(f"trained {len(losses)} steps: loss {losses[0]:.3f} → "
          f"{losses[-1]:.3f}")


if __name__ == "__main__":
    main()
