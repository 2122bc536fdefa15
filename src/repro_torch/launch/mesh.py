"""Device meshes on `torch.distributed`.

Port of `repro.launch.mesh`.  Defined as FUNCTIONS (never module-level
constants), so importing this module touches no device and no process
group.

Both meshes stand on the default process group.  Where none is
initialized, a process started by `torchrun` (`WORLD_SIZE` in its
environment) joins the group its environment describes; any other
process makes a group of one rank on an in-process store (NCCL for
"cuda", gloo for "cpu"), which opens no TCP port.  A "cuda" mesh needs a
CUDA device and a group with NCCL: it never becomes a CPU mesh.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _group(device_type: str) -> int:
    """The default process group's world size, the group made first where
    none is initialized."""
    if device_type not in _BACKEND:
        raise ValueError(f"device_type is 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:  # torchrun
            dist.init_process_group(_BACKEND[device_type])
        else:
            dist.init_process_group(_BACKEND[device_type],
                                    store=dist.HashStore(), rank=0,
                                    world_size=1)
    backend = str(dist.get_backend())
    if device_type == "cuda" and "nccl" not in backend:
        raise RuntimeError(f"a cuda mesh needs an NCCL process group; the "
                           f"default group's backend is {backend!r}")
    return dist.get_world_size()


def _mesh(shape: tuple, axes: tuple, device_type: str):
    n = _group(device_type)
    if n != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The reference's 16x16 chips per pod; multi-pod adds a leading
    "pod" axis.  The process group must have 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(axes=("data",), device_type="cuda"):
    """Every rank of the process group on one axis (tests, examples, the
    training launcher)."""
    return _mesh((_group(device_type),), tuple(axes), device_type)
