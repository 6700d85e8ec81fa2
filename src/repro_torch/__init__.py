"""PyTorch/CUDA port of the ``repro`` correlation-clustering system.

Mirrors ``repro``'s layout (``core/``, ``kernels/``) module for module. It
imports ``torch`` and never ``jax`` or ``repro``; the integer outputs are
bit-identical to the reference for the same inputs and keys.

Every public entry point takes ``device=None``, which means CUDA, and
raises when CUDA is absent unless the caller passes ``device="cpu"``.
"""
