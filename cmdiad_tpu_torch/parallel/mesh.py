"""The process group as a mesh, and the block helpers of a 1-D data axis.

The JAX package lays a ``('data', 'model')`` mesh over the devices of one
process.  The port runs one process a rank instead (``torchrun``, or
``parallel.launch.spawn``), so a ``Mesh`` here is this rank's view of an
initialised ``torch.distributed`` process group: its rank, the mesh shape
(whose product is the world size), its device and the group.  An array
sharded over ``'data'`` is held as this rank's block of rows, the blocks
contiguous and in rank order, as ``PartitionSpec('data')`` lays them out.

NCCL carries the collectives between cards; gloo carries them between CPU
ranks, and between ranks that share one card (NCCL refuses two ranks on one
device).  gloo takes CUDA tensors in every collective used here
(``all_reduce`` with any op, ``all_gather``, ``broadcast``), copying them
through host memory inside the process group, so the callers pass device
tensors under either backend.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cmdiad_tpu_torch.ops.bank_min import ROW_TILE
from cmdiad_tpu_torch.ops.scoring import PAD_VALUE


def torchrun_hint(n: int) -> str:
    return (f"launch one process a rank, e.g. `torchrun --nproc_per_node {n} "
            f"-m cmdiad_tpu_torch.cli detect --mesh_shape {n} ...`, or "
            f"cmdiad_tpu_torch.parallel.launch.spawn")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the process group: mesh ``shape`` (product =
    world size), ``rank``, its ``device`` and the process ``group``."""

    shape: Tuple[int, ...]
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None   # None: the default group

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_mesh(shape: Tuple[int, ...], device) -> Mesh:
    """The mesh of ``shape`` over the initialised default process group,
    whose world size must be ``prod(shape)``.  Raises without a group (the
    error names torchrun) and on a size mismatch: a mesh never drops to
    fewer devices than asked for."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh_shape={shape!r} needs a torch.distributed process group of "
            f"{n} ranks and none is initialised: {torchrun_hint(n)}")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh_shape={shape!r} needs {n} ranks, but the process "
                         f"group has {world}")
    device = torch.device(device)
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL process group needs CUDA devices, got {device}")
    return Mesh(shape, dist.get_rank(), device)


def init_from_env(device_type: str = "cuda") -> torch.device:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and
    return this rank's device: ``cuda:{LOCAL_RANK}`` over NCCL, or the CPU
    over gloo.  Without torchrun's variables nothing is joined and
    ``device_type`` is returned as it is."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return torch.device(device_type)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if torch.device(device_type).type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card: this host shows "
                f"{torch.cuda.device_count()} (NCCL needs one card a rank)")
        device, backend = torch.device("cuda", local), "nccl"
        torch.cuda.set_device(device)
    else:
        device, backend = torch.device("cpu"), "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return device


def _pad(x, multiple: int, fill=None):
    """Rows of ``x`` (numpy or torch) padded to a multiple of ``multiple``
    with copies of row 0 (``fill`` None) or rows of ``fill``."""
    pad = (-x.shape[0]) % multiple
    if not pad:
        return x
    if isinstance(x, np.ndarray):
        extra = (np.repeat(x[:1], pad, axis=0) if fill is None
                 else np.full((pad, *x.shape[1:]), fill, x.dtype))
        return np.concatenate([x, extra])
    extra = (x[:1].expand(pad, *x.shape[1:]) if fill is None
             else x.new_full((pad, *x.shape[1:]), fill))
    return torch.cat([x, extra])


def _block(x, mesh: Mesh, blocks: int):
    rows = x.shape[0] // blocks
    i = mesh.rank * blocks // mesh.size
    return x[i * rows:(i + 1) * rows]


def shard_batch(x, mesh: Mesh, blocks: Optional[int] = None):
    """This rank's block of a batch (numpy or torch, rows first): the batch
    is padded to a multiple of ``blocks`` (default: every rank a block)
    with copies of sample 0, as the JAX package pads a DP scoring batch
    (``methods/base.py:993-999``).  Returns (block, true row count).  With
    fewer blocks than ranks, consecutive ranks share a block (a 2-D mesh's
    'model' axis)."""
    blocks = mesh.size if blocks is None else blocks
    return _block(_pad(x, blocks), mesh, blocks), x.shape[0]


def shard_rows(bank: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of bank rows: the bank is padded with
    ``PAD_VALUE`` rows so that every block is a multiple of the bank-min
    kernels' 64-row tile."""
    return _block(_pad(bank, ROW_TILE * mesh.size, PAD_VALUE), mesh, mesh.size)


def gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's block (equal shapes), concatenated in rank order, on
    every rank."""
    if mesh.size == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts)


def all_agree(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when ``flag`` is true on every rank."""
    t = torch.tensor([int(flag)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(t.item())


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.size > 1:
        dist.barrier(group=mesh.group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the gradients over ranks too: the
    gradient of every rank's loss with respect to this rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)
