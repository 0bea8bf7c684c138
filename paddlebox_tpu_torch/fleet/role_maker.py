"""Role maker and process-group bootstrap.

Port of the JAX package's ``fleet/role_maker.py``. ``PaddleCloudRoleMaker``
reads PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / POD_IP / PADDLE_PORT from
the scheduler (incubate/fleet/base/role_maker.py:480-690). The port reads
torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
first (where the JAX package reads its ``JAX_*`` dialect), then the
reference's ``PADDLE_*`` names, and normalizes either into (rank, world,
coordinator). ``init_distributed`` then creates the ``torch.distributed``
process group over the coordinator, with a finite timeout; the
coordinator is any reachable ``host:port``, so the group spans machines.

Over several hosts a rank is also a node of the host plane
(``parallel/transport.py``): ``PADDLE_TRAINER_ENDPOINTS`` (the reference's
comma-separated ``host:port`` list, one a rank in rank order) becomes
``RoleMaker.endpoints``, and :meth:`RoleMaker.host_transport` builds this
rank's ``TcpTransport`` over them. The port runs one process a card, so
the transport rank, the mesh rank and the owner of mesh shard ``rank`` are
one number::

    role = init_distributed(backend="nccl")   # the device plane
    transport = role.host_transport()         # the host plane
    plan = make_mesh("nccl")
    ds = BoxPSDataset(schema, table, b, n_mesh_shards=role.world,
                      rank=role.rank, nranks=role.world, transport=transport,
                      router=TcpShuffleRouter(transport))
    trainer = CTRTrainer(model, cfg, plan=plan)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class RoleMaker:
    rank: int  # this process's index (worker_index parity)
    world: int  # number of processes (worker_num parity)
    coordinator: Optional[str] = None  # "host:port" of rank 0's store
    # the host plane's "host:port" a rank, in rank order (None: no transport)
    endpoints: Optional[Tuple[str, ...]] = None

    @property
    def is_first_worker(self) -> bool:
        return self.rank == 0

    def worker_index(self) -> int:
        return self.rank

    def worker_num(self) -> int:
        return self.world

    @staticmethod
    def from_env(env: Optional[dict] = None) -> "RoleMaker":
        """rank / world / coordinator from the first dialect found:
        torchrun's -> the reference's PADDLE_* -> a single process.

        Every malformed value raises ``ValueError`` naming its variable: a
        bad scheduler environment fails here, not later inside the
        rendezvous."""
        e = os.environ if env is None else env

        def first(*names, default=None):
            """(name, value) of the first variable set."""
            for n in names:
                if e.get(n) not in (None, ""):
                    return n, e[n]
            return None, default

        def as_int(src, raw, what):
            try:
                return int(raw)
            except (TypeError, ValueError):
                raise ValueError(f"{src}={raw!r} is not a valid integer {what}") from None

        rank_src, rank_raw = first("RANK", "PADDLE_TRAINER_ID", default="0")
        world_src, world_raw = first("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default="1")
        rank = as_int(rank_src or "RANK (default)", rank_raw, "rank")
        world = as_int(world_src or "WORLD_SIZE (default)", world_raw, "world size")
        if world <= 0:
            raise ValueError(f"{world_src or 'WORLD_SIZE'}={world_raw!r}: world size must be >= 1")
        if not (0 <= rank < world):
            raise ValueError(
                f"{rank_src or 'RANK'}={rank_raw!r}: rank {rank} out of range for "
                f"world {world} (from {world_src or 'default'})"
            )
        coord = None
        for host_var, port_var in (("MASTER_ADDR", "MASTER_PORT"), ("POD_IP", "PADDLE_PORT")):
            host, port = e.get(host_var), e.get(port_var)
            if host and port:
                p = as_int(port_var, port, "port")
                if not 0 < p < 65536:
                    raise ValueError(f"{port_var}={port!r} is not a TCP port")
                coord = f"{host}:{p}"
                break
        if world > 1 and coord is None:
            raise ValueError(
                f"{world_src}={world_raw!r} declares a multi-process role but no "
                "coordinator is set (set MASTER_ADDR+MASTER_PORT or POD_IP+PADDLE_PORT)"
            )
        endpoints = None
        raw_eps = e.get("PADDLE_TRAINER_ENDPOINTS")
        if raw_eps:
            endpoints = tuple(x.strip() for x in raw_eps.split(",") if x.strip())
            if len(endpoints) != world:
                raise ValueError(
                    f"PADDLE_TRAINER_ENDPOINTS names {len(endpoints)} endpoints for world {world}"
                )
            for ep in endpoints:
                host, _, port = ep.rpartition(":")
                if not host or not 0 <= as_int("PADDLE_TRAINER_ENDPOINTS", port, "port") < 65536:
                    raise ValueError(f"PADDLE_TRAINER_ENDPOINTS entry {ep!r} is not host:port")
        return RoleMaker(rank=rank, world=world, coordinator=coord, endpoints=endpoints)

    def host_transport(self, timeout: float = 120.0):
        """This rank's node of the host plane: a ``TcpTransport`` over
        ``endpoints`` (it binds its own entry and dials the others
        lazily). Every rank builds one before the first pass."""
        if self.endpoints is None:
            raise ValueError("no host-plane endpoints: set PADDLE_TRAINER_ENDPOINTS (host:port a rank)")
        from paddlebox_tpu_torch.parallel.transport import TcpTransport

        return TcpTransport(self.rank, list(self.endpoints), timeout=timeout)


def init_distributed(
    role: Optional[RoleMaker] = None,
    backend: str = "nccl",
    timeout_s: Optional[float] = None,
) -> RoleMaker:
    """Create the process group for ``role`` (fleet.init parity): a
    single-process role returns at once; a multi-process one calls
    ``init_process_group`` over ``tcp://<coordinator>`` with a finite
    timeout. Build the plan with ``parallel.make_mesh(backend, ...)``
    afterwards; it joins this group."""
    from paddlebox_tpu_torch.parallel import mesh

    role = role if role is not None else RoleMaker.from_env()
    if role.world > 1:
        mesh._init_group(
            backend, role.rank, role.world, f"tcp://{role.coordinator}",
            mesh.DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s,
        )
    return role
