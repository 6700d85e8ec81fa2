#!/usr/bin/env python3
"""Kernel B4 (flash attention) against earlier sources on the card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/attention_sweep.py [--check-only] [--baseline OLD.cu]
                                       [--out sweep.json]

It builds ``csrc/flash_attention.cu`` and prints, per kernel instance,
ptxas's registers, stack and spill bytes, and each (dtype, D)'s shared
memory per block. ``--check-only`` then runs the kernel once at every
``measure.B4_SHAPES`` entry against the plain version within 2e-5 (f32) /
2e-2 (bf16), and at ``measure.B4_LARGE_O_SHAPE`` (bf16 outputs in
[4.5, 7.5]) against the plain version's f32 output within 2e-2, printing
each ``--baseline``'s error there too, and stops: the quick first check
after an edit of the kernel. Without it, at the shapes below it holds the kernel and each
``--baseline`` (an earlier ``flash_attention.cu``, see
``measure.FaBaseline``) to the plain version and times them on the same
random inputs (numpy, seed 0), device ms per call from the profiler, each
in a session of its own in the order A B C … C B A and the mean of its
two passes. ``scaled_dot_product_attention`` is timed beside them as the
yardstick.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import measure as ms  # noqa: E402

# smollm-135m prefills (9 query heads over 3 KV heads of 64): one prompt
# of 512 to 4,096 tokens (1,383 the longest prompt of chip_smoke's serving
# phase) and batches of 2 to 8 prompts of 2,048.
SHAPES = [(b, 9, 3, s, s, 64, True, dt) for dt in ("float32", "bfloat16")
          for b, s in ((1, 512), (1, 1024), (1, 1383), (1, 2048), (1, 4096),
                       (2, 2048), (3, 2048), (4, 2048), (8, 2048))]


def inputs(shape, rng, dev):
    B, H, KH, Sq, Sk, D, causal, dtype = shape
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            .to(dev, getattr(torch, dtype))
            for s in ((B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D))]


def check(name, fn, want, shape):
    err = float((fn().float() - want.float()).abs().max())
    if not err < ms.B4_TOL[shape[-1]]:
        raise AssertionError(f"{name} differs from the plain version by "
                             f"{err} at {shape}")
    return err


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--check-only", action="store_true")
    parser.add_argument("--baseline", type=Path, action="append",
                        default=[], help="another flash_attention.cu; may "
                        "be given more than once")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("attention_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    card = ms.card_line()
    print(f"card: {card}")
    bases = {f"baseline {p.stem}": ms.FaBaseline(p) for p in args.baseline}
    logs = _build.build(["flash_attention"])
    for base in bases.values():
        base.load()
    record = {"card": card, "ptxas": _build.ptxas_report(
        logs.get("flash_attention", "")), "rows": []}
    for r in record["ptxas"]:
        print(f"  {r['registers']} regs, stack {r['stack']} B, spill "
              f"stores {r['spill_stores']} B, loads {r['spill_loads']} B  "
              f"{r['function']}")
    for dt in (torch.float32, torch.bfloat16):
        print(f"  shared memory per block, {dt}: " + ", ".join(
            f"D={d} {fa.smem_bytes(dt, d)} B" for d in fa.HEAD_DIMS))

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    if args.check_only:
        for shape in ms.B4_SHAPES:
            q, k, v = inputs(shape, rng, dev)
            causal = shape[6]
            want = ref.attention_ref(q, k, v, causal=causal)
            err = check("B4", functools.partial(
                fa.flash_attention, q, k, v, causal=causal), want, shape)
            print(f"  {shape}: max abs err {err:.3g}")
            record["rows"].append({"shape": list(shape), "err": err})
        # Outputs in [4.5, 7.5] against the plain version's f32 output.
        shape = ms.B4_LARGE_O_SHAPE
        q, k, v, want = ms.b4_large_output_inputs(shape, rng, dev)
        for name, fn in {"B4": fa.flash_attention, **bases}.items():
            got = fn(q, k, v, causal=True)
            err = ms.b4_large_output_check(got, want, shape)[0] \
                if name == "B4" else float((got.float() - want).abs().max())
            print(f"  {name} at {shape}, |o| in [4.5, 7.5]: max abs err "
                  f"{err:.3g} against the f32 plain output")
            record["rows"].append({"shape": list(shape), "large_o": True,
                                   "kernel": name, "err": err})
    else:
        print(f"device ms per call, A B C ... C B A, the mean of two "
              f"passes  [{card}]")
        for shape in SHAPES:
            q, k, v = inputs(shape, rng, dev)
            want = ref.attention_ref(q, k, v, causal=True)
            fns = {"flash_attention": functools.partial(
                fa.flash_attention, q, k, v, causal=True)}
            for name, base in bases.items():
                fns[name] = functools.partial(base, q, k, v, causal=True)
            errs = {name: check(name, fn, want, shape)
                    for name, fn in fns.items()}
            times = ms.abba_ms(list(fns.values()))
            row = {"shape": list(shape), "errs": errs,
                   "ms": dict(zip(fns, times)),
                   "sdpa_ms": ms.device_ms(
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           q, k, v, is_causal=True, enable_gqa=True)),
                   "bound_ms": ms.b4_bounds(shape)[0]}
            record["rows"].append(row)
            print(f"  {str(tuple(shape)):44s} " + ", ".join(
                f"{name} {ms.fmt_ms(t)}" for name, t in row["ms"].items())
                + f", sdpa {ms.fmt_ms(row['sdpa_ms'])}, bound "
                f"{row['bound_ms']:.4f}")
            del q, k, v, want
            torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
