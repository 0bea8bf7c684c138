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

:class:`MeshPlan` owns every collective the port runs, and nothing else
in the port calls ``torch.distributed`` for data:

- :meth:`MeshPlan.all_to_all`: ``[world, ...]`` blocks, equal splits over
  dim 0; row ``d`` of the result is the block rank ``d`` sent here, which
  is ``lax.all_to_all(x, ax, 0, 0, tiled=True)``;
- :meth:`MeshPlan.all_reduce` (``psum``; ``pmean`` is a sum over world);
- :meth:`MeshPlan.all_gather`, stacking every rank's tensor on a new
  leading axis;
- :meth:`MeshPlan.broadcast`, one rank's tensor on every rank, bit for
  bit (async dense hands rank 0's table params to every rank with it);
- :meth:`MeshPlan.shift`, the pipeline's stage hop (below), which
  ring attention's (k, v) rotation also rides;
- :meth:`MeshPlan.tiled_all_to_all`, ``lax.all_to_all`` with a split and
  a concat dim (``tiled=True``): Ulysses attention's re-partition of the
  heads and the sequence. It is one :meth:`MeshPlan.all_to_all`, and
  differentiable: its backward is the inverse all_to_all.

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
``DistributedWorkingSet`` finalize returns).

The pipeline (``parallel/pipeline.py``) adds two pieces:

- :meth:`MeshPlan.shift`, the cyclic ``lax.ppermute`` with ``perm =
  [(i, (i + 1) % n)]``: rank ``r``'s tensor arrives on rank ``(r + 1) %
  world``. It is one ``all_to_all_single`` with one non-empty split each
  way, a symmetric call on both backends (gloo's ``send`` / ``recv``
  need not take a CUDA tensor, and no rank can wait on a ``recv`` its
  peer has not posted). It is differentiable: its backward sends the
  cotangent back the other way, so every rank must run the same shifts
  in the same order in the forward and in the backward;
- :func:`make_mesh_2d`, the (pipeline x data) grid: rank ``r`` sits at
  ``(r // n_dp, r % n_dp)``, as the JAX package's row-major
  ``reshape(n_pp, n_dp)`` places devices. Every rank creates every
  column (``pp``) and row (``dp``) subgroup, in one order, and the plan
  hands out one 1-D plan an axis (:meth:`MeshPlan.along`) whose rank and
  world are this rank's position along that axis. The JAX function's
  ICI-aware ``mesh_utils`` layout and its ``mesh.device_mesh_fallbacks``
  counter have no counterpart: with one process a card the layout is the
  rank order, so no fallback can happen.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class MeshPlan:
    """This rank's place on the mesh and its process group. A 2-D plan
    (:func:`make_mesh_2d`) also holds one 1-D plan an axis, in ``axes``."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None  # the torch.distributed ProcessGroup (None = default)
    axis: str = "dp"
    calls: Dict[str, int] = field(
        default_factory=lambda: {"all_to_all": 0, "all_reduce": 0, "all_gather": 0, "broadcast": 0, "shift": 0}
    )
    axes: Tuple[Tuple[str, "MeshPlan"], ...] = ()  # (name, that axis's 1-D plan), outer axis first

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The mesh's axes: a 2-D plan's two, else this plan's one."""
        return tuple(name for name, _ in self.axes) or (self.axis,)

    def along(self, name: str) -> "MeshPlan":
        """The 1-D plan of axis ``name``: this rank's position along it,
        the axis's size and its subgroup. A 1-D plan is its own plan along
        its axis."""
        for n, sub in self.axes:
            if n == name:
                return sub
        if not self.axes and name == self.axis:
            return self
        raise ValueError(f"{name!r} is not an axis of the mesh {self.axis_names}")

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
        ranks' ``x`` gives only the shape and dtype). ``src`` is a position
        on this plan's axis; ``dist.broadcast`` takes a global rank, so a
        subgroup's ``src`` is mapped to it."""
        y = x.clone().contiguous()
        self.calls["broadcast"] += 1
        root = src if self.group is None else dist.get_global_rank(self.group, src)
        dist.broadcast(y, src=root, group=self.group)
        return y

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """Rank ``r``'s ``x`` [m, ...] on rank ``(r + 1) % world``: the
        cyclic ``lax.ppermute`` of a pipeline's stage hop. Differentiable;
        the backward is the inverse shift, one more call on every rank."""
        return _Shift.apply(x, self)

    def tiled_all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
        dim ``split_dim`` is cut into ``world`` equal blocks, block ``d``
        goes to rank ``d``, and the blocks received are concatenated
        along ``concat_dim`` in rank order. One :meth:`all_to_all` (one
        count); differentiable, the backward is the inverse all_to_all
        (the two dims swapped), one more call on every rank."""
        if x.shape[split_dim] % self.world:
            raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split into {self.world} blocks")
        return _TiledAllToAll.apply(x, self, split_dim, concat_dim)

    def reset_calls(self) -> None:
        for k in self.calls:
            self.calls[k] = 0
        for _, sub in self.axes:
            sub.reset_calls()


def _rotate(plan: MeshPlan, x: torch.Tensor, step: int) -> torch.Tensor:
    """Rank ``r``'s ``x`` on rank ``(r + step) % world``: one
    ``all_to_all_single`` whose only non-empty input split goes to
    ``r + step`` and whose only non-empty output split comes from ``r - step``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    send, recv = [0] * plan.world, [0] * plan.world
    send[(plan.rank + step) % plan.world] = x.shape[0]
    recv[(plan.rank - step) % plan.world] = x.shape[0]
    plan.calls["shift"] += 1
    dist.all_to_all_single(out, x, output_split_sizes=recv, input_split_sizes=send, group=plan.group)
    return out


class _Shift(torch.autograd.Function):
    """:meth:`MeshPlan.shift` with its gradient: the cotangent takes the
    inverse permutation."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
        ctx.plan = plan
        return _rotate(plan, x, 1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _rotate(ctx.plan, g, -1), None


def _tiled_all_to_all(plan: MeshPlan, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The blocks of ``split_dim`` moved to a leading [world] axis, one
    :meth:`MeshPlan.all_to_all`, then the received blocks laid along
    ``concat_dim`` in rank order."""
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    blocks = x.unflatten(split_dim, (plan.world, -1)).movedim(split_dim, 0)
    got = plan.all_to_all(blocks)  # got[d]: rank d's block for this rank
    return got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _TiledAllToAll(torch.autograd.Function):
    """:meth:`MeshPlan.tiled_all_to_all` with its gradient: the cotangent
    takes the inverse all_to_all."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, plan: MeshPlan, split_dim: int, concat_dim: int) -> torch.Tensor:
        ctx.plan, ctx.dims = plan, (split_dim, concat_dim)
        return _tiled_all_to_all(plan, x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        split_dim, concat_dim = ctx.dims
        return _tiled_all_to_all(ctx.plan, g, concat_dim, split_dim), None, None, None


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


def make_mesh_2d(
    n_pp: int,
    n_dp: int,
    axes: Sequence[str] = ("pp", "dp"),
    backend: str = "nccl",
    device: Optional[torch.device | str] = None,
    rank: Optional[int] = None,
    world: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> MeshPlan:
    """A 2-D (pipeline x data) mesh over the process group: pipeline
    stages along ``axes[0]``, data-parallel replicas of each stage along
    ``axes[1]``. Rank ``r`` sits at ``(r // n_dp, r % n_dp)``.

    Joins the default group as :func:`make_mesh` does (the same
    ``backend`` / ``device`` / ``rank`` / ``world`` rules), then creates
    the ``n_dp`` column groups (one a dp position: the pipeline) and the
    ``n_pp`` row groups (one a stage: its replicas) on every rank, in the
    same order. The plan's ``axis`` is the dp axis, as the JAX package's;
    :meth:`MeshPlan.along` gives each axis's 1-D plan."""
    if n_pp < 1 or n_dp < 1:
        raise ValueError(f"mesh needs n_pp >= 1 and n_dp >= 1, got ({n_pp}, {n_dp})")
    if len(axes) != 2 or axes[0] == axes[1]:
        raise ValueError(f"a 2-D mesh needs two distinct axis names, got {tuple(axes)}")
    need = n_pp * n_dp
    if world is not None and world != need:
        raise ValueError(f"asked for {need} ranks ({n_pp} x {n_dp}), the world has {world}")
    plan = make_mesh(backend, device=device, rank=rank, world=world, init_method=init_method,
                     timeout_s=timeout_s, axis=axes[1])
    if plan.world != need:
        raise ValueError(f"asked for {need} ranks ({n_pp} x {n_dp}), the world has {plan.world}")
    p, d = divmod(plan.rank, n_dp)
    timeout = datetime.timedelta(seconds=timeout_s)
    # every rank creates every group, in this order: a rank that skipped a
    # group it is not in would leave the others waiting in new_group
    cols = [dist.new_group([q * n_dp + c for q in range(n_pp)], timeout=timeout) for c in range(n_dp)]
    rows = [dist.new_group([q * n_dp + c for c in range(n_dp)], timeout=timeout) for q in range(n_pp)]
    pp = MeshPlan(rank=p, world=n_pp, device=plan.device, backend=backend, group=cols[d], axis=axes[0])
    dp = MeshPlan(rank=d, world=n_dp, device=plan.device, backend=backend, group=rows[p], axis=axes[1])
    return MeshPlan(rank=plan.rank, world=need, device=plan.device, backend=backend, axis=axes[1],
                    axes=((axes[0], pp), (axes[1], dp)))


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

