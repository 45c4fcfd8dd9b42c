"""Production mesh factory (counterpart of ``repro.launch.mesh``).

Meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects built by
``init_device_mesh``.  Each factory is a function, never a module-level
constant, so importing this module touches no device and no process
group: a mesh needs a process group of its size (``torch.distributed``
initialised by the caller; the dry run gives it the ``"fake"`` backend).

Topology:
* single pod:  (16, 16)        axes ("data", "model") — 256 devices
* multi-pod:   (2, 16, 16)     axes ("pod", "data", "model") — 512

The factory generalizes to (n_pods, d, m) for elastic scaling: the
checkpoint manifest is mesh-agnostic, so restarts may change n_pods.
"""
from __future__ import annotations

import math
from typing import Tuple

__all__ = ["make_production_mesh", "make_mesh", "mesh_info"]


def _make(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """Elastic variant: any (n_pods, data, model) factorization."""
    return _make(tuple(shape), tuple(axes), device_type)


def mesh_info(mesh) -> dict:
    shape = [int(s) for s in mesh.shape]
    return {"axis_names": list(mesh.mesh_dim_names), "shape": shape,
            "n_devices": math.prod(shape)}
