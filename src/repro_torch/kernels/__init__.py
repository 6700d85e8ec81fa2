"""Hand-written Hopper kernels and their plain PyTorch versions.

  csrc/neighbor_min.cu — CUDA C++ for sm_90a (masked neighbour-min, label
                         agreement over ELL adjacencies)
  _build.py            — nvcc build at first use, loaded with ctypes
  neighbor_min.py      — the kernel wrappers (device checks, launch counts)
                         and the graph-to-ELL helpers
  ref.py               — the plain versions the wrappers use on the CPU

The reference's ``kernels/ops.py`` switches Pallas interpret mode; the
port has no such switch, so the core calls ``neighbor_min`` directly.

Nothing here imports a compiler or touches a GPU at import time.
"""
