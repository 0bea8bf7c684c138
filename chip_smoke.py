#!/usr/bin/env python3
"""Chip smoke for ``paddlebox_tpu_torch`` on one NVIDIA H100.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the serving path from ``paddlebox_tpu_torch/
   ops/csrc`` with nvcc for sm_90a;
3. kernel check: ``pull_rows_cuda`` against its plain version
   ``pull_rows_ref`` on the card, bitwise, at the serving shape and at
   W = 128 and W = 1 (U = 0 and U = 7);
4. the main path at full width — DeepFM, 39 slots, embedx 16, hidden
   (512, 256, 128), batch 4096 — served by ``ScoreServer(device="cuda")``
   from a ``ScoringTable`` of 1 << 22 keys of width 21 made from ``--seed``:
   a few requests (full batches, smaller ones, some concurrent, keys drawn
   hot-head + uniform-tail with misses). Preds must be finite in [0, 1],
   reruns and coalesced requests bitwise equal to direct scoring, the same
   request with the gather forced to ``pull_rows_ref`` bitwise equal, and a
   small request within PRED_ATOL of the port's CPU path. Every kernel of
   the path must have launched during the served run;
5. numbers: the kernel's time at the main path's own shape (CUDA events,
   median of ``TIMING_REPS``, with the L2 flushed and warm), the plain
   version's and ``torch.index_select``'s times, the HBM bound, launches per
   scored batch and request latency p50/p99 — each beside the card's name
   and power limit — then the ``kernels`` line, the nvidia-smi line, and
   last ``{"ok": true, "device": {...}}``.

It exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

NUM_SLOTS = 39
EMBEDX_DIM = 16
HIDDEN = (512, 256, 128)
BATCH = 4096
KEY_SPACE = 1 << 22
HOT_KEYS = 1 << 12  # bench.py's hot head
HOT_FRAC = 0.25
MISS_FRAC = 0.01
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
TIMING_REPS = 30
# bf16 MLP: cuBLAS and the CPU backend round the bf16 products at
# different places; preds are sigmoids, so a logit gap d moves them <= d/4
PRED_ATOL = 2e-2
GATHER_REPLACES = "paddlebox_tpu/ops/pallas_kernels.py:75"


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, flush) -> float:
    """Device time of one call of ``fn``, from CUDA events.

    ``flush`` (a tensor larger than the 50 MB L2, or None for a warm L2) is
    read first, which evicts the inputs and leaves the cache clean. A
    sleep kernel then holds the card while the host enqueues the events and
    ``fn``'s launches, so the events time the device work and not the
    host's launch overhead."""
    if flush is not None:
        flush.sum()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


class TableFollower:
    """The follower a ScoreServer needs: ``version()`` and ``layout``."""

    def __init__(self, table, layout):
        self.table = table
        self.layout = layout

    def version(self):
        return self.table.version()


def make_records(rng, keys, n, miss_frac=MISS_FRAC):
    """``n`` SlotRecords of one key per slot: a quarter from the hot head,
    the rest uniform over the committed keys, ``miss_frac`` absent."""
    from paddlebox_tpu_torch.data import SlotRecord

    idx = rng.integers(0, len(keys), (n, NUM_SLOTS))
    hot = rng.integers(0, HOT_KEYS, (n, NUM_SLOTS))
    idx = np.where(rng.random((n, NUM_SLOTS)) < HOT_FRAC, hot, idx)
    k = keys[idx]
    # committed keys are < 2**63; these never are
    absent = rng.integers(1 << 63, (1 << 64) - 1, (n, NUM_SLOTS), dtype=np.uint64)
    k = np.where(rng.random((n, NUM_SLOTS)) < miss_frac, absent, k)
    labels = (rng.random(n) < 0.2).astype(np.float32)
    u_off = np.arange(NUM_SLOTS + 1, dtype=np.uint32)
    f_off = np.array([0, 1], dtype=np.uint32)
    return [
        SlotRecord(u64_values=k[i], u64_offsets=u_off, f_values=labels[i : i + 1], f_offsets=f_off)
        for i in range(n)
    ]


def check_gather(ck, table, rows, what):
    got = ck.pull_rows_cuda(table, rows)
    torch.cuda.synchronize()
    want = ck.pull_rows_ref(table, rows)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"pull_rows_cuda != pull_rows_ref at {what}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    print(f"kernel check pull_rows_cuda {what}: bitwise equal", flush=True)
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from paddlebox_tpu_torch.data import SlotInfo, SlotSchema, build_batch, pack_batch
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.ops import pull_push
    from paddlebox_tpu_torch import config
    from paddlebox_tpu_torch.serve import ScoreServer, Scorer, ScoringTable, version_source
    from paddlebox_tpu_torch.table import PassWorkingSet, ValueLayout
    from paddlebox_tpu_torch.train import TrainStepConfig
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(f"card: {card}", flush=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
        flush=True,
    )

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    ck.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)

    # ---- 3. kernel check -------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(args.seed)
    max_err = 0.0
    for R, W, U in ((160_000, 21, 160_000), (65_536, 128, 16_384), (100, 1, 0), (100, 1, 7)):
        table = torch.randn((R, W), device=dev, generator=g)
        rows = torch.randint(0, R - 1, (U,), device=dev, generator=g, dtype=torch.int32)
        rows[U - U // 64 :] = R - 1  # the padding row, repeated at the tail
        for r in (rows, rows.long()):
            max_err = max(max_err, check_gather(ck, table, r, f"R={R} W={W} U={U} {r.dtype}"))

    # ---- 4. main path ----------------------------------------------------
    rng = np.random.default_rng(args.seed)
    lay = ValueLayout(embedx_dim=EMBEDX_DIM)
    t0 = time.perf_counter()
    keys = np.unique(rng.integers(1, 1 << 63, KEY_SPACE + KEY_SPACE // 16, dtype=np.uint64))[:KEY_SPACE]
    rows = (0.05 * rng.standard_normal((KEY_SPACE, lay.width), dtype=np.float32))
    show = rng.integers(0, 40, KEY_SPACE).astype(np.float32)
    rows[:, lay.SHOW] = show
    rows[:, lay.CLK] = np.floor(show * 0.3 * rng.random(KEY_SPACE, dtype=np.float32))
    keys_hot_first = keys[rng.permutation(KEY_SPACE)]  # hot head spread over the key space
    model = DeepFM(
        NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
        generator=torch.Generator().manual_seed(args.seed),
    )
    params = {k: v.detach().to(dev) for k, v in model.state_dict().items()}
    print(f"data made: {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    st = ScoringTable(lay.width)
    version = st.commit(keys, rows, date="20261016", delta_idx=0, decay_epoch=0, params=params)
    print(f"commit of {KEY_SPACE} keys: {time.perf_counter() - t0:.3f} s", flush=True)
    del rows

    schema = SlotSchema(
        [SlotInfo("label", type="float", dense=True, dim=1)]
        + [SlotInfo(f"s{i}") for i in range(NUM_SLOTS)],
        label_slot="label",
    )
    cfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=BATCH, layout=lay)
    scorer = Scorer(model, cfg, device="cuda")
    follower = TableFollower(st, lay)
    source = version_source(lay, version)

    full = make_records(rng, keys_hot_first, BATCH)
    small = [make_records(rng, keys_hot_first, n) for n in (1000, 100, 7)]
    mostly_absent = make_records(rng, keys_hot_first, 64, miss_frac=0.9)
    concurrent = [make_records(rng, keys_hot_first, 500) for _ in range(6)]

    t0 = time.perf_counter()
    scorer.score_records(full, schema, source, params)  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    print(f"warm-up batch: {time.perf_counter() - t0:.3f} s", flush=True)

    srv = ScoreServer(follower, scorer, schema, device="cuda")
    batches0 = STAT_GET("serve.batches")
    ck.reset_launch_counts()
    srv.start()
    try:
        served = [srv.score(r, timeout=300.0) for r in [full, full, *small, mostly_absent]]
        pend = [srv.submit(r) for r in concurrent]
        served_conc = [p.result(timeout=300.0) for p in pend]
    finally:
        srv.stop()
    torch.cuda.synchronize()
    counts = dict(ck.launch_counts)
    n_batches = STAT_GET("serve.batches") - batches0
    lat = srv.latency_percentiles()
    print(f"served {lat['n']} requests in {n_batches} batches; kernel launches {counts}", flush=True)
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    if counts["pull_rows_cuda"] != n_batches:
        raise AssertionError(f"{counts['pull_rows_cuda']} gather launches for {n_batches} batches")

    for preds, recs in zip(served + served_conc, [full, full, *small, mostly_absent, *concurrent]):
        if preds.shape != (len(recs),) or not np.all(np.isfinite(preds)):
            raise AssertionError("preds not finite or of the wrong shape")
        if preds.min() < 0.0 or preds.max() > 1.0:
            raise AssertionError("preds outside [0, 1]")
    if not np.array_equal(served[0], served[1]):
        raise AssertionError("two runs of the same request differ")
    for preds, recs in zip(served_conc, concurrent):
        if not np.array_equal(preds, scorer.score_records(recs, schema, source, params)):
            raise AssertionError("a coalesced request differs from scoring it alone")
    print("main path: preds finite in [0, 1]; reruns and coalesced requests bitwise equal", flush=True)

    # the same request with the gather forced to the plain version
    pull_push.pull_rows_cuda = ck.pull_rows_ref
    try:
        plain = scorer.score_records(full, schema, source, params)
    finally:
        pull_push.pull_rows_cuda = ck.pull_rows_cuda
    if not np.array_equal(plain, served[0]):
        raise AssertionError("preds with pull_rows_ref differ from preds with pull_rows_cuda")
    print("main path: bitwise equal with the gather forced to pull_rows_ref", flush=True)

    # reference on a small input: the port's CPU path on the same version
    cpu_scorer = Scorer(
        DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
               generator=torch.Generator().manual_seed(args.seed)),
        cfg, device="cpu",
    )
    cpu_params = {k: v.cpu() for k, v in params.items()}
    cpu_preds = cpu_scorer.score_records(full[:64], schema, source, cpu_params)
    cpu_err = float(np.abs(cpu_preds - served[0][:64]).max())
    print(f"main path: CPU vs GPU preds max |diff| {cpu_err:.3e} (atol {PRED_ATOL})", flush=True)
    if not cpu_err <= PRED_ATOL:
        raise AssertionError(f"GPU preds differ from the CPU path by {cpu_err}")

    # ---- 5. numbers at the main path's own gather shape ------------------
    # the full request's stages on the host clock, then the whole call
    t0 = time.perf_counter()
    batch = build_batch(full, schema)
    t1 = time.perf_counter()
    ws = PassWorkingSet(n_mesh_shards=1)
    ws.add_keys(batch.keys)
    table_np = ws.finalize(source, round_to=config.get_flag("serve_row_bucket"))
    t2 = time.perf_counter()
    db = pack_batch(batch, ws, schema, bucket=config.get_flag("serve_key_bucket"))
    t3 = time.perf_counter()
    table = torch.from_numpy(table_np.reshape(-1, lay.width)).to(dev)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    scorer.score_records(full, schema, source, params)
    t5 = time.perf_counter()
    emit({
        "card": card, "host_clock_ms": {
            "build_batch": (t1 - t0) * 1e3, "working_set_finalize": (t2 - t1) * 1e3,
            "pack_batch": (t3 - t2) * 1e3, "table_h2d": (t4 - t3) * 1e3,
            "score_records_total": (t5 - t4) * 1e3,
        },
    })
    uniq = torch.from_numpy(db.uniq_rows).to(dev)
    R, W = table.shape
    U = uniq.shape[0]
    max_err = max(max_err, check_gather(ck, table, uniq, f"main path R={R} W={W} U={U} int32"))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    fns = {
        "kernel": lambda: ck.pull_rows_cuda(table, uniq),
        "plain": lambda: ck.pull_rows_ref(table, uniq),
        "library": lambda: torch.index_select(table, 0, uniq),
    }
    for fn in fns.values():
        fn()
    cold = {k: [] for k in fns}
    warm = {k: [] for k in fns}
    for rep in range(TIMING_REPS):
        order = list(fns) if rep % 2 == 0 else list(fns)[::-1]
        for k in order:
            cold[k].append(cuda_ms(fns[k], flush))
            warm[k].append(cuda_ms(fns[k], None))
    med = {k: float(np.median(v)) for k, v in cold.items()}
    med_warm = {k: float(np.median(v)) for k, v in warm.items()}
    bytes_moved = 2 * U * W * 4 + 4 * U
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    emit({
        "card": card, "kernel": "pull_rows_cuda", "R": R, "W": W, "U": U,
        "n_uniq": db.n_uniq, "ms": med["kernel"], "plain_ms": med["plain"],
        "index_select_ms": med["library"], "bound_ms": bound_ms, "bytes": bytes_moved,
        "reps": TIMING_REPS, "l2": "cold", "warm_l2_ms": med_warm["kernel"],
        "warm_l2_plain_ms": med_warm["plain"], "warm_l2_index_select_ms": med_warm["library"],
    })
    emit({
        "card": card, "launches_per_batch": counts["pull_rows_cuda"] / n_batches,
        "requests": lat["n"], "batches": n_batches, "request_p50_ms": lat["p50_ms"],
        "request_p99_ms": lat["p99_ms"], "request_max_ms": lat["max_ms"],
    })
    emit({"kernels": [{
        "name": "pull_rows_cuda",
        "route": "cuda",
        "source": "paddlebox_tpu_torch/ops/csrc/gather_rows.cu",
        "replaces": GATHER_REPLACES,
        "launches": counts["pull_rows_cuda"],
        "max_abs_err": max_err,
        "ms": med["kernel"],
        "plain_ms": med["plain"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": med["library"],
    }]})
    print(card, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
