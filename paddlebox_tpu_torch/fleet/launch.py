"""Spawn the ranks of a single-host mesh from one process.

The reference launches one trainer process a GPU (fleet's multiprocess
launcher); ``torchrun --nproc-per-node N script.py`` with
``make_mesh("nccl")`` in the script is the port's production launch.
:func:`spawn` is the in-process counterpart, for a script or a
test that wants N ranks now: it starts ``world`` processes with the
``spawn`` start method (never a fork after CUDA is up), joins each to the
process group with a finite timeout, runs ``fn(plan, *args)`` on every
rank and tears the group down. A rank's exception fails the call: the
other ranks are terminated and the error is raised in the caller.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.multiprocessing as mp

from paddlebox_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, destroy_mesh, make_mesh


def _rank_main(
    rank: int,
    fn: Callable,
    world: int,
    backend: str,
    device: Optional[str],
    init_method: str,
    args: Sequence,
    threads: Optional[int],
    timeout_s: float,
) -> None:
    if threads:
        torch.set_num_threads(threads)
    plan = make_mesh(
        backend, device=device, rank=rank, world=world, init_method=init_method, timeout_s=timeout_s
    )
    try:
        fn(plan, *args)
    finally:
        destroy_mesh()


def spawn(
    fn: Callable,
    world: int,
    init_method: str,
    backend: str,
    device: Optional[str] = None,
    args: Sequence = (),
    threads: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Run ``fn(plan, *args)`` on ``world`` spawned ranks and wait for all.

    ``fn`` must be importable by name (a module-level function).
    ``init_method`` is the rendezvous: ``file://<path>`` (a fresh path a
    group) or ``tcp://localhost:<port>``. ``backend`` has no default:
    ``"nccl"`` puts rank r on ``cuda:r``; ``"gloo"`` runs every rank on
    ``device``. ``threads``
    caps each rank's intra-op threads."""
    mp.start_processes(
        _rank_main,
        args=(fn, world, backend, device, init_method, tuple(args), threads, timeout_s),
        nprocs=world,
        join=True,
        start_method="spawn",
    )
