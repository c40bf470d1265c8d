"""Device mesh, process group and the collectives the distributed runtime uses.

Counterpart of ``sgl_tpu/parallel/mesh.py``.  ``sgl_tpu`` is one process
driving every device through ``shard_map`` over a ``(data, graph)`` mesh;
the port is SPMD, one process per rank, on ``torch.distributed``:

* :func:`init_distributed` joins the process group from an explicit
  ``init_method`` or from the ``torchrun`` environment, and does nothing
  when neither is there;
* :func:`make_mesh` returns a ``DeviceMesh`` with axes ``data`` (batch rows,
  the gradient all-reduce) and ``graph`` (the nodes of the propagation
  ring).  With no process group and no rendezvous it starts a one-rank group
  on a ``HashStore``, so the same code runs alone with no environment;
* :func:`rank_device` is the rank's device: ``cuda:(local_rank % cards)``
  unless the caller asks for the CPU;
* :func:`all_reduce_`, :func:`broadcast_`, :func:`all_gather` and
  :class:`RingExchange` are the collectives over a mesh axis.  A group of one
  rank makes no call.  Gloo gets host tensors only: a CUDA tensor goes
  through a pinned host copy that these helpers make explicitly (the route
  of gloo ranks that share one card); NCCL takes the CUDA tensor itself.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: seconds a collective may wait before the process group fails it
TIMEOUT_S = 60

_RENDEZVOUS_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device_type: Optional[str] = None,
) -> bool:
    """Join the process group; returns True when it was initialized here.

    With no ``init_method`` it initializes only when the environment names
    a rendezvous (``MASTER_ADDR``, ``RANK`` and ``WORLD_SIZE``, as
    ``torchrun`` sets them); a plain single-process run returns False and
    does nothing, so one script runs alone and under ``torchrun``.  The
    backend, unless given, is ``nccl`` when each rank has a card of its own
    (and ``device_type`` is not ``"cpu"``), else ``gloo``.  Every
    collective times out after :data:`TIMEOUT_S`, so a lost rank fails the
    run instead of hanging it.
    """
    if dist.is_initialized():
        return False
    if init_method is None and not all(os.environ.get(k) for k in _RENDEZVOUS_ENV):
        return False
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if backend is None:
        own_card = torch.cuda.is_available() and world_size <= torch.cuda.device_count()
        backend = "nccl" if own_card and device_type != "cpu" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return True


def _ensure_process_group(device_type: Optional[str]) -> None:
    """A process group for :func:`make_mesh`: the configured rendezvous, or
    else a one-rank gloo group on an in-memory store."""
    if dist.is_initialized() or init_distributed(device_type=device_type):
        return
    dist.init_process_group(
        "gloo", store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axis_names: Sequence[str] = ("data", "graph"),
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over every rank of the process group.

    The default shape is ``(1, world_size)``: every rank on the ``graph``
    axis, since propagation is what scales.  Ranks fill the mesh row-major:
    rank ``r`` of a ``(data, graph)`` mesh is at ``(r // graph, r % graph)``.
    The mesh's device type follows the backend (``cuda`` for NCCL, ``cpu``
    for gloo, whose ranks may share a card or run on the CPU); where a
    rank's tensors live is :func:`rank_device`'s choice.  With no group yet,
    ``device_type="cpu"`` makes the one the environment names gloo.
    """
    from torch.distributed.device_mesh import init_device_mesh

    _ensure_process_group(device_type)
    n = dist.get_world_size()
    if shape is None:
        shape = (1, n) if len(axis_names) == 2 else (n,)
    shape = tuple(int(s) for s in shape)
    if int(torch.tensor(shape).prod()) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def rank_device(device=None) -> torch.device:
    """The rank's device: ``cuda:(LOCAL_RANK % device_count)`` by default,
    else ``device`` itself (``"cpu"`` for the CPU; a CUDA device with no
    CUDA raises, as ``sgl_tpu_torch.device.resolve_device`` does)."""
    from sgl_tpu_torch.device import resolve_device

    if device is not None:
        return resolve_device(device)
    resolve_device(None)  # raises without CUDA
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def data_sharding(mesh=None, axis: str = "data") -> list:
    """The placement of batch rows: sharded on dim 0 over the data axis."""
    from torch.distributed.tensor import Shard

    return [Shard(0)]


def replicated(mesh=None) -> list:
    """The placement of parameters: the same on every rank."""
    from torch.distributed.tensor import Replicate

    return [Replicate()]


# -- collectives over one mesh axis -------------------------------------------


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through a host copy for ``group`` (a CUDA tensor
    on gloo)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    if _staged(t, group):
        host = t.to("cpu")
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group``, in place."""
    if dist.get_world_size(group) == 1:
        return t
    if _staged(t, group):
        host = t.to("cpu")
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated on ``dim`` in group
    rank order."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    src = t.contiguous().to("cpu") if _staged(t, group) else t.contiguous()
    out: List[torch.Tensor] = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.cat(out, dim=dim).to(t.device)


class RingExchange:
    """One rotation step of a ring over ``group``: send a block to group rank
    ``p + 1``, receive one from ``p − 1``.

    :meth:`start` posts both transfers and returns at once, so the caller's
    kernel runs while they move; :meth:`finish` waits and returns the block
    received.  Two receive buffers alternate, so a block being sent is never
    written.  On gloo with CUDA blocks the block is first copied into a
    pinned host buffer, and the received one copied from a pinned buffer back
    to the card (``route == "gloo, pinned host copies"``); NCCL and CPU blocks
    move as they are.  :attr:`transfer_s` sums the host seconds spent in
    copies and waits.
    """

    def __init__(self, group, like: torch.Tensor):
        self.group = group
        p, n = dist.get_group_rank(group, dist.get_rank()), dist.get_world_size(group)
        self.dst = dist.get_global_rank(group, (p + 1) % n)
        self.src = dist.get_global_rank(group, (p - 1) % n)
        self.staged = _staged(like, group)
        self.route = ("gloo, pinned host copies" if self.staged
                      else f"{dist.get_backend(group)}, {like.device.type} tensors")
        self.recv = [torch.empty_like(like) for _ in range(2)]
        self.turn = 0
        if self.staged:
            self.host_send = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self.host_recv = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        self.reqs = []
        self.transfer_s = 0.0

    def start(self, block: torch.Tensor) -> None:
        import time

        t = time.perf_counter()
        if self.staged:
            self.host_send.copy_(block)  # waits for the block's producer on the card
            send, recv = self.host_send, self.host_recv
        else:
            send, recv = block, self.recv[self.turn]
        self.reqs = [dist.isend(send, self.dst, group=self.group),
                     dist.irecv(recv, self.src, group=self.group)]
        self.transfer_s += time.perf_counter() - t

    def finish(self) -> torch.Tensor:
        import time

        t = time.perf_counter()
        for req in self.reqs:
            req.wait()
        out = self.recv[self.turn]
        if self.staged:
            out.copy_(self.host_recv, non_blocking=True)  # ordered on the current stream
        self.turn ^= 1
        self.transfer_s += time.perf_counter() - t
        return out
