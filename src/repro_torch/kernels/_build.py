"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library at first use and loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds. The
libraries go to ``kernels/build/`` (ignored by git), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused within a checkout.

Nothing here runs at import time: this module must import on machines with
neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", *ARCH_FLAGS]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all at once.

    One ``nvcc`` per source, started together and then awaited. Returns the
    compiler's output (register and shared-memory use) per source built;
    raises with that output if a build fails.
    """
    started = {name: _start(name) for name in names}
    logs: Dict[str, str] = {}
    for name, job in started.items():
        if job is None:
            continue
        proc, tmp, out = job
        text, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
        os.replace(tmp, out)
        logs[name] = text
    return logs


def sources() -> List[str]:
    """Stems of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def device_and_stream(t):
    """A CUDA tensor's device index and PyTorch's current stream on it: the
    two values every C entry takes, because each library links its own CUDA
    runtime, whose current device is not PyTorch's."""
    import torch

    index = t.device.index
    if index is None:
        index = torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


__all__ = ["build", "load", "sources", "library_path", "nvcc",
           "device_and_stream", "BUILD_DIR"]
