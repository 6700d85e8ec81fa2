"""Device meshes over ``torch.distributed``.

The port of ``repro/launch/mesh.py``. Each function builds a
``DeviceMesh`` (``init_device_mesh`` with ``mesh_dim_names``) over the
ranks of the default process group, which the caller initialises first
(``init_process_group`` with its address, world size and rank); building a
mesh never initialises a group. The mesh's device type follows the
group's backend, NCCL ``cuda`` and gloo ``cpu``; a gloo group may still
carry CUDA tensors (``models/parallel.py`` stages them through host
memory), which is how two ranks share one card.

:func:`standin_mesh` is no mesh at all: the axes of one and a rank's
coordinates, for the dry run (``launch/dryrun.py``) and the tests, which
size and count a rank of a mesh far larger than the cards at hand on the
meta device (``models/parallel.py``, ``StandinMesh``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..models.parallel import StandinMesh

# The reference's production meshes, as {axis: size}.
PRODUCTION_AXES = {False: {"data": 16, "model": 16},
                   True: {"pod": 2, "data": 16, "model": 16}}


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(axes: Mapping[str, int]):
    """A mesh of ``axes`` ({name: size}, outermost first) over the default
    group's ranks, row-major; raises unless the world has exactly that
    many ranks."""
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group before "
                           "building a mesh")
    shape = tuple(axes.values())
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a mesh of {dict(axes)} needs {n} ranks; the "
                         f"world has {world}")
    return init_device_mesh(_device_type(), shape,
                            mesh_dim_names=tuple(axes))


def production_axes(multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh's axis sizes, without building it."""
    return dict(PRODUCTION_AXES[multi_pod])


def make_production_mesh(*, multi_pod: bool = False):
    """``(data 16, model 16)``, or ``(pod 2, data 16, model 16)``."""
    return make_mesh(PRODUCTION_AXES[multi_pod])


def standin_mesh(axes: Mapping[str, int],
                 coords: Optional[Mapping[str, int]] = None) -> StandinMesh:
    """A stand-in for the mesh ``axes`` ({name: size}, outermost first),
    seen from the rank at ``coords`` (the first rank when None), e.g.
    ``standin_mesh(production_axes(True), {"pod": 1, "data": 3,
    "model": 7})``. Needs no process group."""
    return StandinMesh(dict(axes), None if coords is None else dict(coords))


def make_smoke_mesh():
    """Every rank of the world as a 1-D 'data' mesh (tests/examples)."""
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group before "
                           "building a mesh")
    return make_mesh({"data": dist.get_world_size()})


__all__ = ["make_mesh", "make_production_mesh", "make_smoke_mesh",
           "production_axes", "PRODUCTION_AXES", "standin_mesh",
           "StandinMesh"]
