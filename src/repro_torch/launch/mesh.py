"""Device-mesh construction, the PyTorch port of ``repro.launch.mesh``.

Functions only: importing this module sets up no process group and touches
no device.  A mesh is a ``torch.distributed`` ``DeviceMesh`` with named
dimensions over the default process group, whose world size must be the
product of the mesh's shape: NCCL on CUDA (one rank per GPU), gloo on the
CPU.  The single-pod production mesh is 16 x 16 = 256 devices
``(data, model)``; the multi-pod one 2 x 16 x 16 = 512 ``(pod, data,
model)``.  :func:`set_mesh` installs the ambient mesh that
``ShardingPolicy.spec`` and ``shard_act`` read; :func:`launcher_world`
gives a launcher its process group.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any, Iterator, Sequence

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.sharding.policy import CURRENT_MESH


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: str = "cuda") -> Any:
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes``.

    ``device`` is ``cuda`` unless the caller names another; with no GPU a
    CUDA mesh raises rather than falling back to the CPU.  Without a default
    process group one is initialised from the environment (``torchrun``
    sets it): NCCL for CUDA, gloo for the CPU.  On CUDA each rank takes the
    GPU of its ``LOCAL_RANK``.  Raises when the world's size is not the
    product of ``shape``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    world = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if world != size:
        raise ValueError(
            f"a {shape} mesh needs a world of {size} ranks; this world has {world}"
        )
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def set_mesh(mesh: Any) -> Iterator[Any]:
    """Install ``mesh`` as the ambient mesh for the ``with`` body."""
    token = CURRENT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        CURRENT_MESH.reset(token)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> Any:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(device: str = "cuda") -> Any:
    """The one-device ``(data, model)`` mesh (axes present, size 1)."""
    return make_mesh((1, 1), ("data", "model"), device=device)


@contextlib.contextmanager
def launcher_world(device: str = "cuda") -> Iterator[bool]:
    """The process group a launcher runs in, for the ``with`` body, which
    gets whether the group was made here.

    An existing default group is used as it is.  Under ``torchrun`` (``RANK``
    in the environment) the group is made from the environment; otherwise
    a world of one rank joins through a ``FileStore`` in a temporary
    directory.  NCCL on CUDA, gloo on the CPU.  A group made here is
    destroyed when the body exits, so no caller is left holding one.
    """
    if dist.is_initialized():
        yield False
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if "RANK" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1)
        try:
            yield True
        finally:
            dist.destroy_process_group()
