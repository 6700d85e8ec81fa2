"""Measurement-driven launch-plan autotuner for the batched ELL kernels.

The port of ``repro/kernels/autotune.py``. The paper's per-round budget is
the frame: Theorem 26 bounds each PIVOT/MIS round by work proportional to
the capped adjacency width, so the batch engine's round cost lives in two
batched ELL sweeps, :func:`~repro_torch.kernels.neighbor_min.
neighbor_min_ell_batch` (B1: the pivot MIS loop and capture, the
precluster propagation) and :func:`~repro_torch.kernels.neighbor_min.
label_agree_ell_batch` (B2: both cost passes). Tuning is keyed by kernel ×
shape, never by method or objective, so one warmup sweep serves every
registered bucket program at that shape. The agreement kernel is not
tuned, as in the reference.

**What is tuned.** The reference tunes the Pallas row tile
``block_rows``. The port's counterpart is the kernels' launch plan
(:mod:`repro_torch.kernels.neighbor_min`): the l2 route
(:func:`~repro_torch.kernels.neighbor_min.l2_plan`) or the staged route
with one wave of blocks or at most ``block_rows`` rows a block
(:func:`~repro_torch.kernels.neighbor_min.staged_plan`), ``block_rows``
from the reference's :data:`CANDIDATE_BLOCK_ROWS` clamped to R. The
default candidate is always :func:`~repro_torch.kernels.neighbor_min.
launch_plan`'s pick, so "tuned against default" is measured, never
inferred. A cached winner is a :class:`PlanChoice` (route and
``block_rows``), not a plan: a staged plan's block count and shared
memory depend on B, so the plan is rebuilt for every launch shape. Plans
may change timing, never outputs: the sweep holds every candidate's
output to the plain version with ``torch.equal``. On the CPU the plain
version runs whatever the plan, so the one candidate there is
``"plain"``; the cache logic is the same.

**Persistence.** :class:`TuningCache` maps ``(device, kernel, R, W,
batch_tier)`` to a winning choice and saves versioned JSON (an explicit
path or the ``REPRO_TORCH_TUNING_CACHE`` env var, never the reference's
variable) atomically, so a second process warms up with zero sweeps.
Entries are *invalidated, never trusted*: one is honoured only when its
device name, ``torch.__version__``, ``torch.version.cuda`` and the B1/B2
library's source digest match the running process; any other counts as
``stale`` and is a miss.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.util import DeviceLike, next_pow2, resolve_device

from . import neighbor_min as nm
from . import ref as _ref

#: Candidate rows-per-block caps of the staged route (clamped to R).
CANDIDATE_BLOCK_ROWS = (64, 128, 256, 512)
#: The two batched kernels on the bucket program's hot path.
KERNELS = ("neighbor_min", "label_agree")
#: Tier cap: batch axes beyond this share one tuning entry.
MAX_BATCH_TIER = 1024
#: The fields an entry must share with the running process to be used.
IDENTITY_FIELDS = ("device", "torch_version", "cuda_version",
                   "kernel_digest")

_CACHE_ENV = "REPRO_TORCH_TUNING_CACHE"
_FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    """A tuned launch: ``route`` ``"l2"``, ``"staged"`` (``block_rows``
    None = one wave of blocks) or ``"plain"`` (the CPU's plain version)."""

    route: str
    block_rows: Optional[int] = None

    @property
    def name(self) -> str:
        if self.route == "staged" and self.block_rows is not None:
            return f"staged/{self.block_rows}"
        return self.route

    def launch_plan(self, B: int, R: int, W: int
                    ) -> Optional[nm.LaunchPlan]:
        """The plan of one ``(B, R, W)`` launch (None for ``"plain"``)."""
        if self.route == "plain":
            return None
        if self.route == "l2":
            return nm.l2_plan(B, R, W)
        plan = nm.staged_plan(B, R, W, R + 1, self.block_rows)
        if plan is None:
            raise ValueError(f"the staged route cannot run (B, R, W) = "
                             f"{(B, R, W)}")
        return plan


def plan_of(choice: Optional[PlanChoice], B: int, R: int,
            W: int) -> Optional[nm.LaunchPlan]:
    """``choice``'s plan at ``(B, R, W)``; None (the launch plan's own
    pick) when untuned."""
    return None if choice is None else choice.launch_plan(B, R, W)


def batch_tier(b: int) -> int:
    """Pow2 tier of a packed batch axis ``B = G_pad * k`` (capped).

    Buckets are swept and cached per tier, not per exact B.
    """
    return min(MAX_BATCH_TIER, next_pow2(max(1, int(b))))


def candidate_blocks(r: int, candidates: Optional[Sequence[int]] = None
                     ) -> Tuple[int, ...]:
    """Rows-per-block caps for a bucket of R rows: the sweep set clamped
    to R, deduplicated in order."""
    cands = CANDIDATE_BLOCK_ROWS if candidates is None else tuple(candidates)
    out: List[int] = []
    for c in cands:
        c = max(1, min(int(c), int(r)))
        if c not in out:
            out.append(c)
    return tuple(out)


def default_choice(B: int, R: int, W: int, device: DeviceLike) -> PlanChoice:
    """What runs untuned: ``launch_plan``'s route on the card, the plain
    version on the CPU. A function of the device's type and the shape."""
    if torch.device("cuda" if device is None else device).type == "cpu":
        return PlanChoice("plain")
    return PlanChoice(nm.launch_plan(B, R, W, R + 1).route)


def candidate_plans(B: int, R: int, W: int, device: DeviceLike,
                    candidates: Optional[Sequence[int]] = None
                    ) -> Tuple[PlanChoice, ...]:
    """The sweep's candidates at ``(B, R, W)``: the default first, then
    l2, the one-wave staged plan and the staged plans capped at
    :func:`candidate_blocks`, dropping any whose plan at this shape equals
    an earlier one's. ``("plain",)`` on the CPU."""
    default = default_choice(B, R, W, device)
    if default.route == "plain":
        return (default,)
    out: List[PlanChoice] = []
    seen = []
    staged_ok = nm.staged_plan(B, R, W, R + 1) is not None
    for choice in [default, PlanChoice("l2")] + ([PlanChoice("staged")] + [
            PlanChoice("staged", br) for br in candidate_blocks(R, candidates)]
            if staged_ok else []):
        plan = choice.launch_plan(B, R, W)
        if plan not in seen:
            seen.append(plan)
            out.append(choice)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _device_name(kind: str, index: Optional[int]) -> str:
    if kind == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(index)


def device_name(device: DeviceLike = None) -> str:
    """The cache's device field: ``torch.cuda.get_device_name`` or
    ``"cpu"``."""
    dev = resolve_device(device)
    return _device_name(dev.type, dev.index)


@functools.lru_cache(maxsize=None)
def kernel_digest() -> str:
    """The B1/B2 library's name, which carries its source digest."""
    from . import _build

    return _build.library_path("neighbor_min").name


def runtime_identity(device: DeviceLike = None) -> dict:
    """This process's values of :data:`IDENTITY_FIELDS` on ``device``."""
    return {"device": device_name(device),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "kernel_digest": kernel_digest()}


class TuningCache:
    """Persistent ``(device, kernel, R, W, batch_tier) -> PlanChoice`` map.

    File format (versioned JSON)::

        {"version": 1,
         "entries": {
            "NVIDIA H100 80GB HBM3/neighbor_min/4096x32/b256": {
                "route": "staged", "block_rows": 512,
                "device": "NVIDIA H100 80GB HBM3",
                "torch_version": "2.6.0", "cuda_version": "12.6",
                "kernel_digest": "libneighbor_min-0123456789abcdef.so",
                "timings_ms": {"staged": 0.05, "l2": 0.09},
                "speedup_vs_default": 1.2}}}

    Invalidation rule: an entry is honoured only when every field of
    :data:`IDENTITY_FIELDS` matches the running process; anything else is
    counted as ``stale`` and treated as a miss. Counters
    (``hits``/``misses``/``stale``/``sweeps``) are process-local
    telemetry, not persisted.
    """

    def __init__(self, path: Optional[str] = None, autoload: bool = True):
        if path is None:
            path = os.environ.get(_CACHE_ENV) or None
        self.path = path
        self._entries: Dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.sweeps = 0          # completed kernel sweeps this process
        self.sweep_log: List[dict] = []
        if self.path and autoload:
            self.load()

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(device: str, kernel: str, r: int, w: int, tier: int) -> str:
        return f"{device}/{kernel}/{int(r)}x{int(w)}/b{int(tier)}"

    def get(self, kernel: str, r: int, w: int, tier: int,
            device: DeviceLike = None, count: bool = True
            ) -> Optional[PlanChoice]:
        """The winning choice, or None (miss / stale). ``count=False``
        keeps hot-path resolution out of the warmup hit/miss counters."""
        ident = runtime_identity(device)
        entry = self._entries.get(
            self._key(ident["device"], kernel, r, w, tier))
        if entry is None:
            if count:
                self.misses += 1
            return None
        if any(entry.get(f) != ident[f] for f in IDENTITY_FIELDS):
            if count:
                self.stale += 1
                self.misses += 1
            return None
        if count:
            self.hits += 1
        return PlanChoice(entry["route"], entry.get("block_rows"))

    def put(self, kernel: str, r: int, w: int, tier: int,
            choice: PlanChoice, device: DeviceLike = None,
            meta: Optional[dict] = None) -> None:
        ident = runtime_identity(device)
        entry = {"route": choice.route, "block_rows": choice.block_rows,
                 **ident}
        if meta:
            entry.update(meta)
        self._entries[self._key(ident["device"], kernel, r, w, tier)] = entry

    def load(self) -> int:
        """Merge entries from ``path`` (missing/corrupt files are treated
        as empty — a tuning cache is an optimization, never a hard dep)."""
        if not self.path or not os.path.exists(self.path):
            return 0
        try:
            with open(self.path) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return 0
        if not isinstance(blob, dict) \
                or blob.get("version") != _FORMAT_VERSION:
            return 0
        entries = blob.get("entries")
        if not isinstance(entries, dict):
            return 0
        loaded = 0
        for key, entry in entries.items():
            if isinstance(entry, dict) and "route" in entry:
                self._entries[key] = entry
                loaded += 1
        return loaded

    def save(self) -> None:
        if not self.path:
            return
        blob = {"version": _FORMAT_VERSION, "entries": self._entries}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=2, sort_keys=True)
        os.replace(tmp, self.path)

    def info(self) -> dict:
        """Engine-side telemetry block (serialization-safe)."""
        return {
            "path": self.path,
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "stale": self.stale,
            "sweeps": self.sweeps,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "kernel_digest": kernel_digest(),
        }


# Process-default cache (lazy): the executors' resolution and the serving
# warmup must read the same winners or program keys would lie.
_cache: Optional[TuningCache] = None


def tuning_cache() -> TuningCache:
    global _cache
    if _cache is None:
        _cache = TuningCache()
    return _cache


def set_tuning_cache(cache: Optional[TuningCache]) -> Optional[TuningCache]:
    """Swap the process-default cache (tests / explicit paths); returns the
    previous one. ``None`` resets to lazy env-var resolution."""
    global _cache
    prev = _cache
    _cache = cache
    return prev


def tuning_info() -> dict:
    """Default-cache counters + sweep log — the engine-side telemetry."""
    cache = tuning_cache()
    out = cache.info()
    out["sweep_log"] = list(cache.sweep_log)
    return out


def resolve_plans(shape, device: DeviceLike
                  ) -> Optional[Tuple[PlanChoice, PlanChoice]]:
    """Tuned ``(neighbor_min, label_agree)`` choices for a packed
    ``(B, R, W)`` shape on ``device``, or None when the bucket tier is
    untuned (the program key then keeps its untuned form and
    ``launch_plan`` picks). A kernel left untuned in a tuned tier gets the
    default choice. Dict reads only — safe on the hot path."""
    cache = tuning_cache()
    if not len(cache):
        return None
    b, r, w = (int(s) for s in shape)
    tier = batch_tier(b)
    got = [cache.get(kernel, r, w, tier, device=device, count=False)
           for kernel in KERNELS]
    if got == [None, None]:
        return None
    default = default_choice(b, r, w, device)
    return tuple(c if c is not None else default for c in got)


# Launches a timed run queues back to back, and the cycles the card spins
# before it (~2 ms on an H100): long enough for the host to queue them.
_CALLS = 20
_QUEUE_CYCLES = 3_500_000


def _best_ms(fn, dev: torch.device, repeats: int,
             calls: int = _CALLS) -> float:
    """Best of ``repeats`` of ms per call over ``calls`` back-to-back
    calls: on the card, CUDA events around launches queued behind a spin
    kernel, so they run without the host's issue gaps and the time is the
    device's alone (a small launch issues slower than it runs); the host
    clock on the CPU."""
    best = float("inf")
    for _ in range(max(1, repeats)):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_QUEUE_CYCLES)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / calls
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / calls
        best = min(best, ms)
    return best


def sweep_bucket(ell: torch.Tensor, ranks_p: torch.Tensor,
                 elig_p: torch.Tensor, cache: Optional[TuningCache] = None,
                 candidates: Optional[Sequence[int]] = None,
                 repeats: int = 3) -> List[dict]:
    """Time both batched kernels over real packed bucket tensors across
    :func:`candidate_plans`; record winners (and timings) in the cache.

    The inputs are the packed ELL/state tensors a flush of this bucket
    would run, on the device the winners are for — sparsity patterns and
    pad rows are part of what the sweep prices. Each candidate's first
    call (untimed, it also loads the library) is held to the plain
    version with ``torch.equal`` and a difference raises; then it is timed
    best of ``repeats`` over 20 back-to-back launches. A candidate
    that fails to launch raises: nothing falls back. Returns one record
    per kernel, also appended to ``cache.sweep_log``.
    """
    cache = cache if cache is not None else tuning_cache()
    dev = ell.device
    b, r, w = (int(s) for s in ell.shape)
    tier = batch_tier(b)
    cands = candidate_plans(b, r, w, dev, candidates)
    default = cands[0]
    # Labels for the cost-pass kernel: contents barely affect timing, so
    # any valid labelling with the -1 pad sentinel works.
    labels_p = torch.cat(
        [torch.arange(r, dtype=torch.int32, device=dev).expand(b, r),
         torch.full((b, 1), -1, dtype=torch.int32, device=dev)],
        dim=1).contiguous()
    runs = {
        "neighbor_min": (
            lambda plan: nm.neighbor_min_ell_batch(ell, ranks_p, elig_p,
                                                   plan=plan),
            lambda: _ref.neighbor_min_ref(ell, ranks_p, elig_p)),
        "label_agree": (
            lambda plan: nm.label_agree_ell_batch(ell, labels_p, plan=plan),
            lambda: _ref.label_agree_ref(ell, labels_p)),
    }
    records: List[dict] = []
    for kernel in KERNELS:
        run, plain = runs[kernel]
        want = plain()
        timings: Dict[str, float] = {}
        for choice in cands:
            plan = choice.launch_plan(b, r, w)
            if not torch.equal(run(plan), want):
                raise AssertionError(
                    f"{kernel} on plan {choice.name} differs from its plain "
                    f"version at (B, R, W) = {(b, r, w)}")
            timings[choice.name] = _best_ms(lambda: run(plan), dev, repeats)
        winner = min(cands, key=lambda c: timings[c.name])
        speedup = timings[default.name] / max(timings[winner.name], 1e-12)
        record = {
            "kernel": kernel, "R": r, "W": w, "batch": b, "tier": tier,
            "device": device_name(dev),
            "candidates": [c.name for c in cands],
            "timings_ms": dict(timings),
            "equal": True,
            "winner": winner.name,
            "winner_route": winner.route,
            "winner_block_rows": winner.block_rows,
            "default": default.name,
            "default_ms": timings[default.name],
            "winner_ms": timings[winner.name],
            "speedup_vs_default": speedup,
        }
        cache.put(kernel, r, w, tier, winner, device=dev,
                  meta={"timings_ms": record["timings_ms"],
                        "speedup_vs_default": speedup})
        cache.sweeps += 1
        cache.sweep_log.append(record)
        records.append(record)
    cache.save()
    return records


def host_provenance() -> dict:
    """Host/runtime metadata for benchmark records, plus the tuning-cache
    state (whose invalidation fields live here too): torch and CUDA
    versions, the device's name, count and (where ``nvidia-smi`` exists)
    power limit."""
    import platform

    cuda = torch.cuda.is_available()
    out = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "power_limit": None,
        "cpu_count": os.cpu_count(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "tuning_cache": tuning_cache().info(),
    }
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        query = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True)
        if query.returncode == 0:
            out["power_limit"] = query.stdout.strip().splitlines()[0] \
                if query.stdout.strip() else None
    return out


__all__ = [
    "CANDIDATE_BLOCK_ROWS",
    "KERNELS",
    "MAX_BATCH_TIER",
    "IDENTITY_FIELDS",
    "PlanChoice",
    "TuningCache",
    "batch_tier",
    "candidate_blocks",
    "candidate_plans",
    "default_choice",
    "device_name",
    "kernel_digest",
    "runtime_identity",
    "plan_of",
    "tuning_cache",
    "set_tuning_cache",
    "tuning_info",
    "resolve_plans",
    "sweep_bucket",
    "host_provenance",
]
