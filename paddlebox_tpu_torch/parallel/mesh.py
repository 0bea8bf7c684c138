"""The process-group mesh: one process a card, one ``dp`` axis.

Port of the JAX package's ``parallel/mesh.py``. The JAX mesh is
single-controller: one process drives ``n`` devices and ``shard_map`` runs
the per-device step on each. PyTorch's idiom is SPMD, one process a card
in a ``torch.distributed`` process group; the port takes that idiom and
keeps the JAX package's single-host semantics:

- the minibatch is data-parallel over ``dp``, and the pass table is
  *sharded* over the same axis (the table dwarfs the dense net, so data
  parallelism and "table model parallelism" share one axis): rank ``r``
  holds ``table[r]``, and the sparse pull/push ride ``all_to_all``;
- dense gradients are all-reduced over ``dp``.

:class:`MeshPlan` owns the four collectives the port runs, and nothing
else in the port calls ``torch.distributed`` for data:

- :meth:`MeshPlan.all_to_all`: ``[world, ...]`` blocks, equal splits over
  dim 0; row ``d`` of the result is the block rank ``d`` sent here, which
  is ``lax.all_to_all(x, ax, 0, 0, tiled=True)``;
- :meth:`MeshPlan.all_reduce` (``psum``; ``pmean`` is a sum over world);
- :meth:`MeshPlan.all_gather`, stacking every rank's tensor on a new
  leading axis;
- :meth:`MeshPlan.broadcast`, one rank's tensor on every rank, bit for
  bit (async dense hands rank 0's table params to every rank with it).

The backend is an explicit argument. ``nccl`` runs one rank a card,
rank ``r`` on ``cuda:r``, and refuses a world larger than the visible
cards. ``gloo`` takes an explicit ``device``: its ranks may share one card
or run on the CPU (the CPU tests spawn gloo ranks on ``cpu``). On a CUDA
tensor a gloo collective waits for the card and copies through the host
inside the library; an NCCL collective is queued on the stream and waits
for nothing. Nothing here picks a backend on its own.

Each collective adds one to :attr:`MeshPlan.calls` under its name, so a
caller can count the collectives (and, under gloo on a card, the host
syncs they imply) of a step.

Over several hosts the group spans machines (``fleet.init_distributed``
gives its address) and each rank is also a node of the host plane
(``parallel/transport.py``). The JAX package runs one process a host,
which owns several devices and places its process-local blocks into
global arrays (``put_per_device_copies``, ``put_axis1_blocks``, the local
form of ``put_sharded``). The port runs one process a card, so every one
of those placements reduces to "this rank's own block on its card": they
are ported as that, and ``put_sharded`` takes either the global array
(leading dim ``world``) or this rank's block (leading dim 1, what a
``DistributedWorkingSet`` finalize returns). The JAX module's
``make_mesh_2d`` (pipeline x data) is not ported.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

_BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class MeshPlan:
    """This rank's place on the 1-D mesh and its process group."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None  # the torch.distributed ProcessGroup (None = default)
    axis: str = "dp"
    calls: Dict[str, int] = field(
        default_factory=lambda: {"all_to_all": 0, "all_reduce": 0, "all_gather": 0, "broadcast": 0}
    )

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [world, ...] -> [world, ...]: block ``d`` of the result is
        block ``rank`` of rank ``d``'s ``x`` (equal splits over dim 0)."""
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all needs a leading [{self.world}] axis, got {tuple(x.shape)}")
        x = x.contiguous()
        out = torch.empty_like(x)
        self.calls["all_to_all"] += 1
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (``op="sum"``) or max (``op="max"``) of ``x`` over the ranks,
        into a new tensor; ``x`` is left as it was."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        y = x.clone().contiguous()
        self.calls["all_reduce"] += 1
        dist.all_reduce(y, op=ops[op], group=self.group)
        return y

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked on a new leading axis: [world, ...]."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        self.calls["all_gather"] += 1
        dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, into a new tensor (the other
        ranks' ``x`` gives only the shape and dtype)."""
        y = x.clone().contiguous()
        self.calls["broadcast"] += 1
        dist.broadcast(y, src=src, group=self.group)
        return y

    def reset_calls(self) -> None:
        for k in self.calls:
            self.calls[k] = 0


def _init_group(backend: str, rank: int, world: int, init_method: Optional[str], timeout_s: float) -> None:
    """``init_process_group`` with a finite timeout, so a collective that
    loses its peers fails instead of hanging. ``init_method`` defaults to
    ``env://`` (torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``). A group
    that exists already is kept."""
    if dist.is_initialized():
        return
    kw = {}
    if backend == "nccl":
        # binds the communicator to this rank's card at once
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
        **kw,
    )


def make_mesh(
    backend: str = "nccl",
    device: Optional[torch.device | str] = None,
    rank: Optional[int] = None,
    world: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    axis: str = "dp",
) -> MeshPlan:
    """Join the default process group, creating it when it does not exist.

    ``rank`` / ``world`` default to the environment
    (:meth:`~paddlebox_tpu_torch.fleet.RoleMaker.from_env`: torchrun's
    ``RANK`` / ``WORLD_SIZE``, or the ``PADDLE_*`` dialect). ``nccl`` puts
    rank ``r`` on ``cuda:r`` and raises when ``world`` exceeds the visible
    cards; ``gloo`` needs ``device`` (``cuda:0`` for ranks that share a
    card, ``cpu``)."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r} not in {_BACKENDS}")
    if dist.is_initialized():
        got = dist.get_backend()
        if got != backend:
            raise ValueError(f"the process group runs {got!r}, asked for {backend!r}")
        g_rank, g_world = dist.get_rank(), dist.get_world_size()
        if (rank is not None and rank != g_rank) or (world is not None and world != g_world):
            raise ValueError(
                f"the process group is rank {g_rank} of {g_world}, asked for {rank} of {world}"
            )
        rank, world = g_rank, g_world
    elif rank is None or world is None:
        from paddlebox_tpu_torch.fleet.role_maker import RoleMaker

        role = RoleMaker.from_env()
        rank = role.rank if rank is None else rank
        world = role.world if world is None else world
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range for world {world}")
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if world > n_cards:
            raise ValueError(
                f"nccl runs one rank a card: world {world} > {n_cards} visible cards "
                "(ranks that share a card need backend='gloo' with an explicit device)"
            )
        want = torch.device("cuda", rank)
        if device is not None and torch.device(device) != want:
            raise ValueError(f"nccl puts rank {rank} on {want}, asked for {device}")
        dev = want
        torch.cuda.set_device(dev)
    else:
        if device is None:
            raise ValueError("backend='gloo' needs an explicit device ('cpu' or a card)")
        from paddlebox_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
    _init_group(backend, rank, world, init_method, timeout_s)
    return MeshPlan(rank=rank, world=world, device=dev, backend=backend, group=None, axis=axis)


def destroy_mesh() -> None:
    """Tear the default process group down (a no-op when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def axis_size(plan: MeshPlan) -> int:
    return plan.world


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def put_sharded(plan: MeshPlan, x: Any) -> Any:
    """A global array (or a dict / tuple of them) with a leading [world]
    axis -> this rank's block ``x[rank]`` on the plan's device, without the
    leading axis. A leading dim of 1 is this rank's block already (the
    multi-host local form) and is placed as it is."""
    if isinstance(x, dict):
        return {k: put_sharded(plan, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)) and not isinstance(x, np.ndarray):
        return type(x)(put_sharded(plan, v) for v in x)
    t = _as_tensor(x)
    if t.shape[0] == plan.world:
        return t[plan.rank].to(plan.device, copy=True)
    if t.shape[0] == 1:
        return t[0].to(plan.device, copy=True)
    raise ValueError(
        f"put_sharded: leading dim {t.shape[0]} is neither world {plan.world} nor this rank's block (1)"
    )


def put_per_device_copies(plan: MeshPlan, arr: np.ndarray) -> torch.Tensor:
    """This host's array on this rank's card. The JAX function copies a
    process's array onto each of its local devices as one global
    ``[n_devices, ...]`` array (the multi-host resident feed: every host's
    pass arrays differ); with one process a card the copy a device gets is
    this rank's, so the result is ``arr`` on the plan's device."""
    return _as_tensor(arr).to(plan.device, copy=True)


def put_axis1_blocks(plan: MeshPlan, local: np.ndarray) -> torch.Tensor:
    """Local ``[K, 1, ...]`` blocks -> this rank's ``[K, ...]`` on its
    card. The JAX function assembles every host's ``[K, n_local_dev, ...]``
    blocks into a global ``[K, n_dev, ...]`` array split on axis 1 (the
    resident feed's per-chunk index blocks); a rank holds one device's
    column, so it keeps axis 1's single entry."""
    t = _as_tensor(local)
    if t.dim() < 2 or t.shape[1] != 1:
        raise ValueError(f"put_axis1_blocks: axis-1 dim of {tuple(t.shape)} != this rank's 1 device")
    return t[:, 0].to(plan.device, copy=True)


def put_replicated(plan: MeshPlan, x: Any) -> Any:
    """A copy of ``x`` (a tensor, an array, or a dict / tuple of them) on
    the plan's device. Every rank must pass the same values."""
    if isinstance(x, dict):
        return {k: put_replicated(plan, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)) and not isinstance(x, np.ndarray):
        return type(x)(put_replicated(plan, v) for v in x)
    return _as_tensor(x).to(plan.device, copy=True)


def local_slice(plan: MeshPlan, x: torch.Tensor) -> np.ndarray:
    """This rank's block of an axis-0-sharded array -> the whole array
    [world, ...] on the host, every rank's block gathered (the JAX
    function's single-process answer). Over several hosts the trainer
    keeps a rank's own block instead (``CTRTrainer.trained_table``)."""
    return plan.all_gather(x).cpu().numpy()

