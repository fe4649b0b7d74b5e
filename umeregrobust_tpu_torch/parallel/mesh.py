"""Device mesh and data-parallel helpers on torch.distributed (port of
umeregrobust_tpu/parallel/mesh.py).

The layout is the JAX package's: parameters and optimizer state
replicated, the batch (pairs) split over the mesh's 'dp' dimension, the
gradients summed over 'dp' (train/trainer.make_train_step(mesh=...)), and
the points axis of a large cloud split over 'sp'
(parallel/points_sharded.py). A mesh is a
torch.distributed.device_mesh.DeviceMesh with dimensions ('dp', 'sp')
over every rank of the default process group, one rank a card. A
program of several processes starts its group first
(torch.distributed.init_process_group, with its address, world size and
rank); where no group runs, `make_mesh` starts one of this process alone
(NCCL on the card, gloo on the CPU).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from umeregrobust_tpu_torch.devices import resolve_device

__all__ = ["make_mesh", "shard_batch", "replicate", "P", "mesh_device",
           "dim_rank"]


class P(tuple):
    """A partition spec, for names only (P("dp", None)): the port places
    tensors by explicit slices and collectives, not by specs."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


def make_mesh(n_dp: Optional[int] = None, n_sp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh with ('dp', 'sp') dimensions over all ranks of the default
    process group; n_dp defaults to world size // n_sp. On the card (the
    default) each rank takes card rank % device count; raises without
    CUDA unless device_type="cpu"."""
    dev = resolve_device(device_type)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_sp
    if n_dp * n_sp != world:
        raise ValueError(f"mesh {n_dp} x {n_sp} does not cover the "
                         f"{world} ranks of the process group")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (n_dp, n_sp),
                            mesh_dim_names=("dp", "sp"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def dim_rank(mesh: DeviceMesh, name: str):
    """(this rank's coordinate along mesh dimension `name`, its size)."""
    g = mesh.get_group(name)
    return dist.get_rank(g), dist.get_world_size(g)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def shard_batch(mesh: DeviceMesh, tree):
    """This rank's contiguous slice of every leaf's leading (batch) axis,
    on its device: the slice shard_map's P("dp") gives the rank's 'dp'
    coordinate. The axis must divide by the 'dp' size."""
    r, n = dim_rank(mesh, "dp")
    dev = mesh_device(mesh)

    def put(x):
        t = _tensor(x)
        if t.shape[0] % n:
            raise ValueError(f"batch axis {t.shape[0]} does not divide by "
                             f"the 'dp' size {n}")
        k = t.shape[0] // n
        return t[r * k:(r + 1) * k].to(dev)

    return _tree_map(put, tree)


def replicate(mesh: DeviceMesh, tree):
    """Every leaf as rank 0's tensor on every rank (a broadcast from the
    mesh's first rank), on this rank's device."""
    dev = mesh_device(mesh)
    src = int(mesh.mesh.flatten()[0])

    def put(x):
        t = _tensor(x).to(dev).contiguous().clone()
        dist.broadcast(t, src=src)
        return t

    return _tree_map(put, tree)
