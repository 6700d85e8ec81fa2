"""Hand-written Hopper kernels and their plain PyTorch versions.

  csrc/neighbor_min.cu    — CUDA C++ for sm_90a (masked neighbour-min, label
                            agreement over ELL adjacencies; B1, B2)
  csrc/mis_pivot.cu       — CUDA C++ for sm_90a (every MIS round and the
                            PIVOT capture of one graph's k samples; B3)
  csrc/flash_attention.cu — CUDA C++ for sm_90a (attention forward; B4)
  _build.py               — nvcc build at first use, loaded with ctypes
  neighbor_min.py         — B1, B2 wrappers (device checks, launch counts),
                            their one-graph form and the graph-to-ELL
                            helpers
  mis_pivot.py            — the B3 wrapper and its launch plan
  flash_attention.py      — the B4 wrapper
  ref.py                  — the plain versions the wrappers use on the CPU
  measure.py              — timing, bounds and the A/B baseline on the card

The reference's ``kernels/ops.py`` switches Pallas interpret mode; the
port has no such switch, so the core calls ``neighbor_min`` and the
models call ``flash_attention`` directly.

Nothing here imports a compiler or touches a GPU at import time.
"""
