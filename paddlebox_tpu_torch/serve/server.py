"""Batched score serving over a follower's table versions.

Port of the JAX package's ``serve/server.py``. Two layers:

- :class:`Scorer` — the forward-only step on one device. It reuses the
  eval path of ``train/train_step.py`` (forward + metrics, no pushes, no
  dense update), so serving numerics are the trainer's eval numerics. Per
  request it builds a small PassWorkingSet from the request's keys, pulls
  rows from a row source (a follower TableVersion), packs with the
  standard packer, copies the working-set table to the device in one
  transfer, and runs one step. Shapes are bucketed on three axes — records
  pad to the configured batch size, working-set capacity rounds to
  ``serve_row_bucket``, flat keys to ``serve_key_bucket`` — so the device
  sees a small bounded family of shapes.

- :class:`ScoreServer` — an in-process batching front-end: requests queue
  up, a single batcher thread coalesces them (up to the batch size, waiting
  at most ``serve_batch_wait_ms``), scores them against the follower's
  current version, and resolves per-request futures.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.device_pack import pack_batch
from paddlebox_tpu_torch.data.slot_record import build_batch
from paddlebox_tpu_torch.metrics.auc import auc_init
from paddlebox_tpu_torch.obs.histogram import Histogram
from paddlebox_tpu_torch.serve.scoring_table import TableVersion
from paddlebox_tpu_torch.table.sparse_table import PassWorkingSet
from paddlebox_tpu_torch.train.train_step import TrainState, make_train_step
from paddlebox_tpu_torch.utils.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_OBSERVE, STAT_SET


class ServeOverloadError(RuntimeError):
    """Typed load-shed refusal: the batcher queue is past
    ``serve_shed_queue_depth``. Clients treat it as retriable."""


class ServeTimeoutError(TimeoutError):
    """Typed per-request deadline expiry: the batcher did not answer
    within the caller's budget (``serve_request_timeout_ms`` by default)."""


class _RowSource:
    """Adapter giving PassWorkingSet.finalize a host-table interface over
    any pull function."""

    def __init__(self, layout, pull_fn):
        self.layout = layout
        self._pull = pull_fn

    def pull_or_create(self, keys: np.ndarray) -> np.ndarray:
        return self._pull(keys)


def version_source(layout, version: TableVersion) -> _RowSource:
    """Row source over an immutable served version; misses (keys the
    published model has never seen) pull the zero row and are counted.
    A version with a device tier pulls through the miss-fallback ladder
    (``lookup_rows_tiered``: tier rows first, host rows for its misses),
    the same rows bitwise either way."""

    def pull(keys: np.ndarray) -> np.ndarray:
        rows, _, n_miss = version.lookup_rows_tiered(keys)
        if n_miss:
            STAT_ADD("serve.miss_keys", n_miss)
        return rows

    return _RowSource(layout, pull)


def table_source(layout, table) -> _RowSource:
    """Row source over any table with ``pull_or_create(keys)``."""
    return _RowSource(layout, table.pull_or_create)


class Scorer:
    """Forward-only scoring on one device.

    Stateless across requests: params and the row source are per call, so
    one Scorer serves every version — the dense params are applied to the
    module with ``torch.func.functional_call``. Thread-safe: concurrent
    score_records calls build independent working sets.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        cfg,
        device: DeviceLike = "cuda",
        dense_slot: Optional[str] = None,
        dense_dim: int = 0,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dense_slot = dense_slot
        self.dense_dim = dense_dim
        self.model = model.to(self.device).eval()

        def model_apply(params, slot_feats, dense):
            return functional_call(self.model, params, (slot_feats, dense))

        self._step = make_train_step(model_apply, cfg, eval_mode=True)

    def score_records(
        self, records: Sequence, schema, source: _RowSource, params, opt_state=None
    ) -> np.ndarray:
        """preds float32 [len(records)] — deterministic in (rows, params)."""
        if params is None:
            raise RuntimeError(
                "no dense params to score with — the follower has not "
                "loaded a published dense file yet"
            )
        params = {k: v.to(self.device) for k, v in params.items()}
        n, B = len(records), self.cfg.batch_size
        out = np.empty(n, dtype=np.float32)
        for lo in range(0, n, B):
            chunk = list(records[lo : lo + B])
            out[lo : lo + len(chunk)] = self._score_chunk(
                chunk, schema, source, params, opt_state
            )
        return out

    def _score_chunk(self, records, schema, source, params, opt_state) -> np.ndarray:
        m = len(records)
        # pad to the batch size by repeating the tail record: per-example
        # forward math never mixes examples, so preds[:m] do not depend on
        # what rides in the ghost rows
        padded = records + [records[-1]] * (self.cfg.batch_size - m)
        batch = build_batch(padded, schema)
        ws = PassWorkingSet(n_mesh_shards=1)
        ws.add_keys(batch.keys)
        dev = ws.finalize(source, round_to=config.get_flag("serve_row_bucket"))
        db = pack_batch(
            batch,
            ws,
            schema,
            dense_slot=self.dense_slot,
            dense_dim=self.dense_dim,
            bucket=config.get_flag("serve_key_bucket"),
        )
        state = TrainState(
            # the working-set table: one host->device copy
            table=torch.from_numpy(dev.reshape(-1, source.layout.width)).to(self.device),
            params=params,
            opt_state=opt_state,
            auc=auc_init(self.cfg.auc_buckets, device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        feed = {k: torch.from_numpy(v).to(self.device) for k, v in db.as_dict().items()}
        _, metrics = self._step(state, feed)
        return metrics["preds"][:m].cpu().numpy().astype(np.float32)


class _Pending:
    """One submitted request: records in, preds (or an error) out."""

    __slots__ = ("records", "t_submit", "done", "preds", "error", "delta_idx")

    def __init__(self, records):
        self.records = records
        self.t_submit = time.perf_counter()
        self.done = threading.Event()
        self.preds: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.delta_idx: int = -1

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            STAT_ADD("serve.request_timeouts")
            raise ServeTimeoutError(
                f"score request timed out after {timeout}s — the batcher "
                "never answered (wedged scorer or overloaded queue)"
            )
        if self.error is not None:
            raise self.error
        return self.preds


class ScoreServer:
    """In-process batched scoring front-end over a follower.

    ``follower`` is any object with ``version() -> TableVersion`` and
    ``layout``. One batcher thread owns all scoring; submitters only
    enqueue and wait on their request's event. ``device`` names the card
    the scorer runs on and must be the scorer's own.
    """

    def __init__(self, follower, scorer: Scorer, schema, device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        if dev != scorer.device:
            raise ValueError(
                f"ScoreServer on {dev} but its scorer runs on {scorer.device}"
            )
        self.device = dev
        self.follower = follower
        self.scorer = scorer
        self.schema = schema
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # per-server latency distribution, mirrored into the global
        # registry via STAT_OBSERVE
        self.latency_hist = Histogram()  # thread-safe itself
        self.served_indices: List[int] = []  # guarded-by: _lock
        self.staleness: List[Tuple[int, float]] = []  # guarded-by: _lock

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._batcher, name="score-batcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    # ---- request surface -------------------------------------------------

    def submit(self, records: Sequence) -> _Pending:
        if not len(records):
            raise ValueError("empty score request")
        depth = int(config.get_flag("serve_shed_queue_depth"))
        if depth > 0 and self._q.qsize() >= depth:
            # shed at admission, not mid-queue
            STAT_ADD("serve.shed_requests")
            raise ServeOverloadError(
                f"score queue holds >= {depth} requests "
                "(serve_shed_queue_depth) — request shed"
            )
        req = _Pending(list(records))
        self._q.put(req)
        return req

    def score(
        self, records: Sequence, timeout: Optional[float] = None
    ) -> np.ndarray:
        """Submit + wait. ``timeout=None`` means the
        ``serve_request_timeout_ms`` flag — a deadline always applies."""
        if timeout is None:
            timeout = float(config.get_flag("serve_request_timeout_ms")) / 1000.0
        return self.submit(records).result(timeout)

    def queue_depth(self) -> int:
        """Requests waiting for the batcher."""
        return self._q.qsize()

    # ---- batcher ---------------------------------------------------------

    def _batcher(self) -> None:
        wait_s = float(config.get_flag("serve_batch_wait_ms")) / 1000.0
        B = self.scorer.cfg.batch_size
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            reqs = [first]
            total = len(first.records)
            deadline = time.perf_counter() + wait_s
            while total < B:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                reqs.append(nxt)
                total += len(nxt.records)
            self._serve_batch(reqs)

    def _serve_batch(self, reqs: List[_Pending]) -> None:
        # one consistent (version, params) pair for the whole batch
        v = self.follower.version()
        params, opt_state = v.params, v.opt_state
        records = [r for req in reqs for r in req.records]
        try:
            preds = self.scorer.score_records(
                records,
                self.schema,
                version_source(self.follower.layout, v),
                params,
                opt_state,
            )
        except BaseException as e:  # noqa: BLE001 — fault must reach submitters
            for req in reqs:
                req.error = e
                req.done.set()
            STAT_ADD("serve.request_errors", len(reqs))
            return
        now_unix = time.time()
        if v.first_served_unix is None and v.published_unix is not None:
            # train-to-serve staleness: publish -> first answer from it
            v.first_served_unix = now_unix
            lag = now_unix - v.published_unix
            STAT_SET("serve.staleness_s", lag)
            with self._lock:
                self.staleness.append((v.delta_idx, lag))
        t_done = time.perf_counter()
        lo = 0
        with self._lock:
            for req in reqs:
                req.preds = preds[lo : lo + len(req.records)]
                req.delta_idx = v.delta_idx
                lo += len(req.records)
                lat_ms = (t_done - req.t_submit) * 1000.0
                self.latency_hist.observe(lat_ms)
                STAT_OBSERVE("serve.latency_ms", lat_ms)
                # the SLO-facing per-request series: one sample per request
                STAT_OBSERVE("serve.request_ms", lat_ms)
                self.served_indices.append(v.delta_idx)
        for req in reqs:
            req.done.set()
        STAT_ADD("serve.requests", len(reqs))
        STAT_ADD("serve.records", len(records))
        STAT_ADD("serve.batches")
        STAT_SET("serve.served_delta_idx", v.delta_idx)

    # ---- reporting -------------------------------------------------------

    def latency_percentiles(self) -> dict:
        """n, p50_ms, p99_ms, max_ms over the requests served so far."""
        h = self.latency_hist
        n = h.count
        if n == 0:
            return {"n": 0}
        p50, p99 = h.quantiles((0.5, 0.99))
        return {
            "n": n,
            "p50_ms": float(p50),
            "p99_ms": float(p99),
            "max_ms": float(h.max),
        }
