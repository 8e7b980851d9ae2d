"""The data-parallel mesh on ``torch.distributed``: one process per device.

Port of :mod:`spoofsv_tpu.parallel.mesh`. JAX runs one process over N
devices and XLA inserts the collectives; PyTorch runs one process per
device, so the port's mesh is an explicit object, :class:`Mesh`: this
process's rank in its process group, the group's size, the rank's device
and the data axis. The batch axis is split by rows (rank ``r`` of ``n``
takes rows ``[r·B/n, (r+1)·B/n)``, :func:`batch_sharding`); parameters and
optimizer state are replicated by a broadcast from rank 0
(:func:`replicate_tree`); outputs are all-gathered so that every rank holds
the global result, as a JAX global array is whole on every host; gradients
are all-reduced (mean) in buckets (:func:`all_reduce_grads`).

The backend follows the device: NCCL for CUDA tensors, gloo for CPU
tensors. gloo with CUDA tensors is taken only when asked for by name, for
ranks that share one card (NCCL refuses two ranks on one device); gloo
moves CUDA tensors in broadcast and all-reduce but not in all-gather, so
such a mesh gathers through the host (:attr:`Mesh.staging` ``"host"``).
Every gather and broadcast moves bytes (a ``uint8`` view of the tensor), so
the result is bit-equal to what the sending rank holds, whatever the dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

#: the gradient all-reduce's bucket size, bytes of f32 gradients per call
BUCKET_BYTES = 25 << 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a data-parallel group (one rank a device).

    A mesh without a process group (``backend`` None, ``size`` 1) is the
    single-device mesh: every collective is the identity. A group of one
    rank runs its collectives all the same (the NCCL path at world size
    1). ``staging`` says how :meth:`all_gather` moves tensors: ``"device"``
    (the backend gathers them where they are) or ``"host"`` (through CPU
    copies: gloo with CUDA tensors)."""
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]
    data_axis: str = "data"

    @property
    def staging(self) -> str:
        return "host" if self.backend == "gloo" and self.device.type == "cuda" else "device"

    @property
    def grouped(self) -> bool:
        """True when the mesh has a process group (of any size)."""
        return self.backend is not None

    # -- collectives (the identity on a single-device mesh) -------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """Where a tensor must lie for this backend's broadcast/all-reduce."""
        if self.backend == "nccl" and t.device.type != "cuda":
            return t.to(self.device)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``t`` on every rank with rank ``src``'s bytes."""
        if not self.grouped:
            return t
        w = self._wire(t.detach()).contiguous()
        flat = w.reshape(-1).view(torch.uint8)
        dist.broadcast(flat, src=src)
        if w.data_ptr() != t.data_ptr():
            with torch.no_grad():
                t.copy_(w)
        return t

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """Rank ``src``'s picklable ``obj`` on every rank."""
        if not self.grouped:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def all_reduce_(self, t: torch.Tensor, mean: bool = False) -> torch.Tensor:
        """Sum (or mean) of ``t`` over the ranks, in place; every rank ends
        with the same values."""
        if not self.grouped:
            return t
        w = self._wire(t)
        dist.all_reduce(w, op=dist.ReduceOp.SUM)
        if mean:
            w.div_(self.size)
        if w is not t:
            t.copy_(w)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of a tensor, detached (a new tensor)."""
        return self.all_reduce_(t.detach().clone(), mean=True)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated on dim 0, rank order, bit-exact;
        every rank's ``t`` must have the same shape and dtype."""
        if not self.grouped:
            return t
        src = t.detach().contiguous()
        if self.staging == "host":
            src = src.cpu()
        out = torch.empty((self.size, *src.shape), dtype=src.dtype, device=src.device)
        recv = out.view(-1).view(torch.uint8)
        dist.all_gather(list(recv.chunk(self.size)), src.reshape(-1).view(torch.uint8))
        return (out.flatten(0, 1) if src.dim() else out).to(t.device)


def active(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when it has a process group, else None: the data-parallel
    paths run for a grouped mesh of any size, so a group of one rank runs
    them too."""
    return mesh if mesh is not None and mesh.grouped else None


def make_mesh(n_devices: Optional[int] = None, device=None, data_axis: str = "data") -> Mesh:
    """The mesh of this process's group (as
    :func:`spoofsv_torch.parallel.multihost.initialize_distributed` made
    it), or the single-device mesh when there is no group and
    ``n_devices`` is None or 1. ``device``: this rank's device (default: the
    CUDA device ``LOCAL_RANK`` of a CUDA group's backend, else the CPU)."""
    from spoofsv_torch.parallel import multihost

    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {n_devices} ranks needs a process group: "
                               "initialize_distributed first (or run the CLIs with --mesh)")
        return Mesh(0, 1, torch.device(device if device is not None else "cpu"), None,
                    data_axis)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}) in a group of {size} ranks")
    dev = multihost._indexed(torch.device(device)) if device is not None \
        else multihost.rank_device()
    return Mesh(dist.get_rank(), size, dev, dist.get_backend(), data_axis)


class LocalRows(dict):
    """A batch that holds this rank's rows already (a mesh-aware loader's),
    not the global batch."""


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows (it must divide
    the data axis, as a ``NamedSharding(P('data'))`` requires)."""
    if batch % mesh.size:
        raise ValueError(f"batch {batch} does not divide the data axis of {mesh.size} ranks")
    per = batch // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(mesh: Mesh) -> torch.device:
    """Where a replicated tensor lives: whole, on each rank's device."""
    return mesh.device


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of each array of a global batch, on its device."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        out[k] = v[batch_sharding(mesh, v.shape[0])].to(mesh.device)
    return out


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.state_dict(keep_vars=True).values()
    elif isinstance(tree, torch.optim.Optimizer):
        for p in (p for g in tree.param_groups for p in g["params"]):
            yield from (v for v in tree.state.get(p, {}).values() if isinstance(v, torch.Tensor))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def replicate_tree(tree: Any, mesh: Mesh) -> Any:
    """Broadcast every tensor of ``tree`` (a tensor, module, optimizer,
    train state, or a dict/list/tuple of them) from rank 0, in place, so
    every rank holds rank 0's values; returns ``tree``."""
    if mesh.grouped:
        for t in _tensors(tree):
            mesh.broadcast_(t.data if isinstance(t, nn.Parameter) else t)
    return tree


def all_reduce_grads(params: Iterable[torch.Tensor], mesh: Mesh,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each parameter's ``.grad`` by the ranks' mean, in buckets of
    about ``bucket_bytes`` (one flat all-reduce a bucket). A parameter
    without a gradient takes part as zeros on every rank, and keeps
    ``None`` where every rank has none."""
    if not mesh.grouped:
        return
    params = [p for p in params if p.requires_grad]
    have = torch.tensor([float(p.grad is not None) for p in params], device=mesh.device)
    mesh.all_reduce_(have)
    params = [p for p, h in zip(params, have.tolist()) if h > 0]
    bucket: List[torch.nn.Parameter] = []
    size = 0
    for p in params + [None]:
        if p is not None:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            bucket.append(p)
            size += p.numel() * p.grad.element_size()
        if bucket and (p is None or size >= bucket_bytes):
            flat = torch.cat([q.grad.reshape(-1) for q in bucket])
            mesh.all_reduce_(flat, mean=True)
            off = 0
            for q in bucket:
                q.grad.copy_(flat[off: off + q.numel()].view_as(q.grad))
                off += q.numel()
            bucket, size = [], 0
