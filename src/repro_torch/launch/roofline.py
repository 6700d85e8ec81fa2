"""Roofline models on the H100: the LM step of a dry-run cell, and the
batched ELL kernels (B1, B2).

The port of ``repro/launch/roofline.py``.

**The LM half.** :func:`forward_flops`, :func:`step_flops`,
:func:`model_flops`, :func:`active_param_count` and :func:`hbm_bytes` are
the reference's analytic counts, term for term, so the same config and
shape give the same float. :class:`Roofline` keeps the reference's fields,
properties and ``as_dict`` keys; its rates are the H100 SXM's datasheet
figures from ``kernels/measure.py``: compute at ``BF16_TENSOR_OPS_PER_S``
unless the caller passes its own peak (a run in f32 with TF32 off passes
``NON_TENSOR_OPS_PER_S``), memory at ``HBM_BYTES_PER_S``, collectives at
``cluster_dryrun.link_bytes_per_s(chips)`` a card (NVLink within the 8
cards of a node, InfiniBand beyond), where the reference has its TPU's
inter-chip link. They are models at datasheet rates, not measurements.

The reference walks the compiled HLO for its collective bytes
(``collective_stats``) and reads XLA's ``cost_analysis`` for
``hlo_flops_raw`` / ``hlo_bytes_raw``. Eager PyTorch compiles no program,
so there is no HLO to read: the dry run (``launch/dryrun.py``) counts the
collectives a rank issues on a stand-in mesh and passes their bytes times
the ranks as ``coll_bytes``, and the two raw figures stay ``None`` in
``as_dict``.

Two counts of attention differ on purpose, and both stay as they are.
:func:`_attn_flops` counts a causal layer's scores whole (every query
against every key, ``2·T·kv·H·hd·2``), as the reference does.
``measure.b4_bounds`` counts only the (row, key) pairs the causal mask
lets through, and charges f32 at three TF32 products. So for the same
call the roofline's attention term and B4's row in ``PERF.md``'s kernel
table differ by about 2x on causal shapes.

**The ELL half.** The two kernels the bucket program spends its rounds in
(``kernels/neighbor_min.py``), one invocation sweeping a ``(B, R, W)``
int32 ELL adjacency. The model gives the autotuner's checks a hardware
lower bound to hold measured device times against: a time below the model
means the measurement (or the model) is broken. Its constants are the
H100 SXM's: 3.35 TB/s of device memory and 67 TOP/s outside the tensor
cores.

**The ELL byte count differs from the reference's on purpose.** The
reference charges one gathered word per ELL slot per state table, the
TPU's gather from VMEM. On the H100's staged route the state of the graphs
a block works on sits in shared memory, so those gathers move no
device-memory bytes, and the least the function must move is each input
read once and the output written once: the ELL, the state rows
(``neighbor_min``: int32 ranks and a bool active flag a slot;
``label_agree``: int32 labels) and the int32 output.
:func:`ell_kernel_bytes` is that count, and ``measure.bytes_and_ops``
delegates to it, so the kernel table's B1/B2 bounds and this model are one
number.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kernels.measure import (BF16_TENSOR_OPS_PER_S,
                                         HBM_BYTES_PER_S,
                                         NON_TENSOR_OPS_PER_S)

from .cluster_dryrun import link_bytes_per_s

HBM_BW = HBM_BYTES_PER_S
PEAK_OPS = NON_TENSOR_OPS_PER_S
PEAK_FLOPS_BF16 = BF16_TENSOR_OPS_PER_S


# ---------------------------------------------------------------------------
# Analytic FLOPs/bytes per (config × shape), the reference's arithmetic.
# ---------------------------------------------------------------------------


def _attn_flops(cfg, tokens: int, kv_len: int) -> float:
    """Matmul FLOPs for attention projections + scores+values per token set
    (a causal layer's scores counted whole: module docstring)."""
    d, hd = cfg.d_model, cfg.head_dim
    nq = cfg.num_heads * hd
    nkv = cfg.num_kv_heads * hd
    proj = 2.0 * tokens * d * (nq + 2 * nkv) + 2.0 * tokens * nq * d
    scores = 2.0 * tokens * kv_len * cfg.num_heads * hd * 2  # qk^T + pv
    return proj + scores


def _mlp_flops(cfg, tokens: int, ff: Optional[int] = None) -> float:
    f = ff or cfg.d_ff
    return 2.0 * tokens * cfg.d_model * f * 3


def forward_flops(cfg, batch: int, seq: int, kv_len: Optional[int] = None,
                  moe_impl: str = "sort", is_decode: bool = False) -> float:
    """Forward-pass matmul FLOPs of ``batch`` × ``seq`` tokens against
    ``kv_len`` keys (``seq`` when None).

    ``is_decode``: cross-attention K/V and encoder/image towers are cached —
    only the new token's q/self-kv projections and scores are paid.
    """
    t = batch * seq
    kv = kv_len if kv_len is not None else seq
    total = 0.0
    if cfg.family in ("dense", "vlm"):
        per = _attn_flops(cfg, t, kv) + _mlp_flops(cfg, t)
        if cfg.family == "vlm":
            g = cfg.num_layers // cfg.cross_attn_every
            n_self = cfg.num_layers - g
            total += n_self * (_attn_flops(cfg, t, kv) + _mlp_flops(cfg, t))
            timg = 0 if is_decode else batch * cfg.num_image_tokens
            d, hd = cfg.d_model, cfg.head_dim
            xproj = (2.0 * t * d * cfg.num_heads * hd
                     + 2.0 * timg * d * 2 * cfg.num_kv_heads * hd
                     + 2.0 * t * cfg.num_heads * hd * d)
            xscores = 2.0 * t * cfg.num_image_tokens * cfg.num_heads * hd * 2
            total += g * (xproj + xscores + _mlp_flops(cfg, t))
        else:
            total += cfg.num_layers * per
    elif cfg.family == "moe":
        ff = cfg.moe_d_ff or cfg.d_ff
        router = 2.0 * t * cfg.d_model * cfg.num_experts
        expert = _mlp_flops(cfg, t, ff) * cfg.experts_per_tok
        if moe_impl == "einsum":
            cap = t * cfg.experts_per_tok * 1.25
            expert = 2.0 * cap * cfg.d_model * ff * 3
            dispatch = 2.0 * t * cfg.num_experts * (
                cap / cfg.num_experts) * cfg.d_model * 2
            expert += dispatch
        total += cfg.num_layers * (_attn_flops(cfg, t, kv) + router + expert)
    elif cfg.family == "ssm":   # rwkv6
        d = cfg.d_model
        per_tm = 2.0 * t * d * d * 4 + 2.0 * t * d * d  # r,k,v,g proj + out
        h, n = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        per_wkv = 2.0 * t * h * n * n * 3               # scores/state/out
        per_cm = 2.0 * t * d * cfg.d_ff * 2 + 2.0 * t * d * d
        total += cfg.num_layers * (per_tm + per_wkv + per_cm)
    elif cfg.family == "hybrid":
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        h = d_in // cfg.ssm_head_dim
        n = cfg.ssm_state
        proj = 2.0 * t * d * (2 * d_in + 2 * n + h) + 2.0 * t * d_in * d
        chunk = 64.0
        ssd = 2.0 * t * chunk * n + 2.0 * t * chunk * cfg.ssm_head_dim * h
        ssd += 2.0 * t * n * d_in * 2
        total += cfg.num_layers * (proj + ssd)
        g = cfg.num_layers // cfg.attn_every
        total += g * (_attn_flops(cfg, t, kv) + _mlp_flops(cfg, t))
    elif cfg.family == "encdec":
        te = 0 if is_decode else batch * cfg.encoder_seq
        if not is_decode:
            total += cfg.encoder_layers * (
                _attn_flops(cfg, te, cfg.encoder_seq) + _mlp_flops(cfg, te))
        d, hd = cfg.d_model, cfg.head_dim
        self_part = _attn_flops(cfg, t, kv)
        xproj = (2.0 * t * d * cfg.num_heads * hd
                 + 2.0 * te * d * 2 * cfg.num_kv_heads * hd
                 + 2.0 * t * cfg.num_heads * hd * d)
        xscores = 2.0 * t * cfg.encoder_seq * cfg.num_heads * hd * 2
        total += cfg.num_layers * (self_part + xproj + xscores
                                   + _mlp_flops(cfg, t))
    # embedding lookup ~ free; lm head:
    total += 2.0 * t * cfg.d_model * cfg.padded_vocab
    return total


def step_flops(cfg, shape, moe_impl: str = "sort") -> float:
    """Total FLOPs of one step of this cell: forward and backward (3
    forwards) for train, a forward for prefill, one token against the
    ``seq_len`` cache for decode."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 3.0 * forward_flops(cfg, b, s, moe_impl=moe_impl)  # fwd+bwd
    if shape.kind == "prefill":
        return forward_flops(cfg, b, s, moe_impl=moe_impl)
    # decode: one token against kv_len cache
    return forward_flops(cfg, b, 1, kv_len=s, moe_impl=moe_impl,
                         is_decode=True)


def model_flops(cfg, shape) -> float:
    """6·N·D with N = (active) params, D = processed tokens (train);
    2·N·D for inference kinds (fwd only)."""
    n = active_param_count(cfg)
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d_tokens


def active_param_count(cfg) -> int:
    """``param_count`` less the experts a token does not visit."""
    n = cfg.param_count()
    if cfg.num_experts:
        ff = cfg.moe_d_ff or cfg.d_ff
        inactive = (cfg.num_experts - cfg.experts_per_tok) * 3 * cfg.d_model * ff
        n -= cfg.num_layers * inactive
    return n


def hbm_bytes(cfg, shape, param_bytes: int, cache_bytes: int = 0,
              opt_bytes: int = 0) -> float:
    """Analytic HBM traffic per step: weights are read once per microbatch
    pass (fwd + bwd re-read + optimizer read/write), caches read+written,
    activations ~ 2× residual stream per layer."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        traffic = param_bytes * 3.0 + opt_bytes * 2.0
    elif shape.kind == "prefill":
        traffic = param_bytes + cache_bytes
    else:
        traffic = param_bytes + cache_bytes  # full cache read each token
    t = b * (s if shape.kind != "decode" else 1)
    act = 2.0 * t * cfg.d_model * 2 * max(1, cfg.num_layers)
    return traffic + act


@dataclasses.dataclass
class Roofline:
    """The three times of one step on ``chips`` cards, and their shares.

    ``peak_flops``, ``mem_bw`` and ``link_bw`` are per card; None takes
    the H100's: bf16 tensor peak, HBM rate, and
    ``link_bytes_per_s(chips)``. ``hlo_flops_raw`` / ``hlo_bytes_raw``
    are None in the port (module docstring)."""
    chips: int
    flops: float
    bytes_hbm: float
    coll_bytes: float
    hlo_flops_raw: Optional[float]
    hlo_bytes_raw: Optional[float]
    model_flops_: float
    peak_flops: Optional[float] = None
    mem_bw: Optional[float] = None
    link_bw: Optional[float] = None

    @property
    def peak(self) -> float:
        return (self.peak_flops if self.peak_flops is not None
                else PEAK_FLOPS_BF16)

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak)

    @property
    def t_memory(self) -> float:
        bw = self.mem_bw if self.mem_bw is not None else HBM_BW
        return self.bytes_hbm / (self.chips * bw)

    @property
    def t_collective(self) -> float:
        bw = (self.link_bw if self.link_bw is not None
              else link_bytes_per_s(self.chips))
        return self.coll_bytes / (self.chips * bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops_ / max(1.0, self.flops)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term-bound step time that is useful
        model compute."""
        t_star = max(self.t_compute, self.t_memory, self.t_collective)
        t_model = self.model_flops_ / (self.chips * self.peak)
        return t_model / max(t_star, 1e-30)

    def as_dict(self) -> dict:
        return {
            "chips": self.chips,
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "collective_bytes": self.coll_bytes,
            "hlo_flops_raw": self.hlo_flops_raw,
            "hlo_bytes_raw": self.hlo_bytes_raw,
            "model_flops": self.model_flops_,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# --- Batched ELL kernel models (the clustering engine's hot loop) ----------

ELL_KERNELS = ("neighbor_min", "label_agree")


def _check_kernel(kernel: str) -> None:
    if kernel not in ELL_KERNELS:
        raise ValueError(f"unknown ELL kernel {kernel!r}; "
                         f"expected one of {ELL_KERNELS}")


def ell_kernel_flops(kernel: str, b: int, r: int, w: int) -> float:
    """Element-op count of one batched ELL kernel invocation.

    Per (entry, row, col): ``neighbor_min`` does a rank gather, an activity
    gather, a select and a running min (≈4 ops); ``label_agree`` does a
    label gather, a compare and an accumulate (≈3 ops). Integer ops on the
    CUDA cores, not tensor-core flops.
    """
    _check_kernel(kernel)
    per_elem = 4.0 if kernel == "neighbor_min" else 3.0
    return per_elem * b * r * w


def ell_kernel_bytes(kernel: str, b: int, r: int, w: int) -> float:
    """Device-memory bytes one batched ELL kernel invocation must move:
    the (B, R, W) int32 ELL read once, the (B, R+1) state rows read once
    (``neighbor_min``: int32 ranks + bool active, 5 bytes a slot;
    ``label_agree``: int32 labels, 4), the (B, R) int32 output written
    once (module docstring: no gathered words, unlike the reference)."""
    _check_kernel(kernel)
    state_bytes = 5 if kernel == "neighbor_min" else 4
    return float(4 * b * r * w + state_bytes * b * (r + 1) + 4 * b * r)


@dataclasses.dataclass(frozen=True)
class KernelRoofline:
    """Roofline model of one batched ELL kernel invocation (no
    collectives — batch entries are independent)."""

    kernel: str
    b: int
    r: int
    w: int
    flops: float
    bytes_hbm: float
    peak_flops: float
    mem_bw: float

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / self.mem_bw

    @property
    def t_model(self) -> float:
        """The model's lower bound on the invocation's device time (s)."""
        return max(self.t_compute, self.t_memory)

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    def as_dict(self) -> dict:
        return {
            "kernel": self.kernel,
            "shape": [self.b, self.r, self.w],
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_model_s": self.t_model,
            "bottleneck": self.bottleneck,
        }


def ell_kernel_roofline(kernel: str, b: int, r: int, w: int, *,
                        peak_flops: float = PEAK_OPS,
                        mem_bw: float = HBM_BW) -> KernelRoofline:
    """Roofline bound for one ``(B, R, W)`` batched ELL kernel invocation
    (H100 SXM constants by default; on a slower part it is still a lower
    bound, which is how the checks use it)."""
    return KernelRoofline(kernel=kernel, b=int(b), r=int(r), w=int(w),
                          flops=ell_kernel_flops(kernel, b, r, w),
                          bytes_hbm=ell_kernel_bytes(kernel, b, r, w),
                          peak_flops=peak_flops, mem_bw=mem_bw)


__all__ = [
    "HBM_BW", "PEAK_OPS", "PEAK_FLOPS_BF16",
    "forward_flops", "step_flops", "model_flops", "active_param_count",
    "hbm_bytes", "Roofline",
    "ELL_KERNELS", "ell_kernel_flops", "ell_kernel_bytes",
    "KernelRoofline", "ell_kernel_roofline",
]
