"""Overlapped feed pipeline: background pack ahead of the device step.

Port of the JAX package's ``data/pipeline.py``. The reference keeps GPUs
fed by packing minibatches on pinned host buffers in worker threads ahead
of compute (MiniBatchGpuPack, data_feed.h:1418-1542). Here a small thread
pool runs ``fn`` (the native pack, GIL-released, plus pinning) for batches
N+1..N+depth while the device steps batch N. The consumer sees results
strictly in job order; ``depth`` bounds host memory.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, TypeVar

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire
from paddlebox_tpu_torch.utils.monitor import STAT_ADD

T = TypeVar("T")
R = TypeVar("R")

config.define_flag("feed_pipeline_workers", 3, "background packer thread count")
config.define_flag("feed_pipeline_depth", 6, "max batches packed ahead of compute")
config.define_flag(
    "feed_pipeline_retries",
    1,
    "re-runs of a failed prefetch job before its exception surfaces (a "
    "transient packer hiccup should not kill the pass)",
)


def prefetch(
    jobs: Iterable[T],
    fn: Callable[[T], R],
    workers: Optional[int] = None,
    depth: Optional[int] = None,
    retries: Optional[int] = None,
) -> Iterator[R]:
    """Yield ``fn(job)`` in job order, computing up to ``depth`` jobs ahead
    on ``workers`` threads. A failed job is re-run up to ``retries`` times
    in the consumer's thread, at its own position; a persistent exception
    surfaces there, so the order is the same with or without the window."""
    workers = workers or config.get_flag("feed_pipeline_workers")
    depth = depth or config.get_flag("feed_pipeline_depth")
    if retries is None:
        retries = config.get_flag("feed_pipeline_retries")

    def run(job: T) -> R:
        _fault_fire("pipeline.prefetch_job")
        return fn(job)

    it = iter(jobs)
    ex = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="prefetch")
    futs: deque = deque()
    try:
        for job in it:
            futs.append((job, ex.submit(run, job)))
            if len(futs) >= depth:
                break
        sentinel = object()
        while futs:
            job, f = futs.popleft()
            nxt = next(it, sentinel)
            if nxt is not sentinel:
                futs.append((nxt, ex.submit(run, nxt)))
            try:
                out = f.result()
            except Exception:
                for attempt in range(max(0, retries)):
                    STAT_ADD("pipeline_prefetch_retries")
                    try:
                        out = run(job)
                        break
                    except Exception:
                        if attempt + 1 >= retries:
                            raise
                else:
                    raise
            yield out
    finally:
        for _, f in futs:
            f.cancel()
        ex.shutdown(wait=True, cancel_futures=True)
