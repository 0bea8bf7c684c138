"""The push merge (``ops/cuda_kernels.py``: ``merge_rows_cuda``, its plain
version ``merge_rows_ref`` and ``merge_order``) and the order the resident
batch builder hands it.

On the CPU: ``merge_rows_ref`` and ``scale_and_merge_grads`` give the
former merge's bits (a copy of it is kept here: the scaled, masked rows
concatenated with ``valid`` and ``label * valid``, then ``segment_sum`` by
``inverse``) over random inverses with pad keys, empty runs, long runs and
the ``U_pad - 1`` trash slot, with and without ``ins_weight``, ``slot_lr``
and ``grad_div``; the builder's ``merge_order`` and ``merge_offsets`` are
``argsort(inverse, stable=True)`` and its run starts, at ragged slot
lengths of 1-9 and at one key a slot; the CUDA wrapper refuses CPU
tensors. The tests marked ``card`` hold the kernel to the plain version's
bits on the card at PW 13, 35 and 131 with each option, and one resident
DLRM-shaped and one DeepFM-shaped step to the plain route's table, params
and AUC, with one launch a training step and none an eval step. This file
imports no JAX, so the card's machine runs those with
``python -m pytest tests/test_torch_merge_rows.py --noconftest -m card``.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.models import DLRM, DeepFM
from paddlebox_tpu_torch.ops import cuda_kernels as ck
from paddlebox_tpu_torch.ops.seqpool_cvm import segment_sum
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig, build_device_batch
from paddlebox_tpu_torch.train import train_step
from paddlebox_tpu_torch.train.resident_step import ResidentPass
from paddlebox_tpu_torch.utils.fs import fs_open_write

torch.set_num_threads(2)

OPTIONS = list(itertools.product([False, True], repeat=3))  # ins_weight, slot_lr, grad_div
OPTION_IDS = [f"w{int(w)}_lr{int(lr)}_div{int(d)}" for w, lr, d in OPTIONS]


def _former_merge(cfg, gflat, segments, inverse, labels, num_segments, ins_weight=None, grad_div=1.0):
    """The merge as ``scale_and_merge_grads`` ran it before the kernel."""
    S, b = cfg.num_slots, cfg.batch_size
    if grad_div != 1.0:
        gflat = torch.div(gflat, torch.full((), grad_div, dtype=gflat.dtype, device=gflat.device))
    if cfg.slot_lr is not None:
        slot_of_key = torch.clamp(segments // b, max=S - 1).long()
        lr_tab = torch.tensor(cfg.slot_lr, dtype=torch.float32, device=gflat.device)
        gflat = gflat * lr_tab[slot_of_key][:, None]
    pad_mask = (segments < S * b).to(torch.float32)
    ins_of_key = (segments % b).long()
    valid = pad_mask if ins_weight is None else pad_mask * ins_weight[ins_of_key]
    gflat = gflat * pad_mask[:, None]
    ext = torch.cat([gflat, valid[:, None], (labels[ins_of_key] * valid)[:, None]], dim=1)
    summed = segment_sum(ext, inverse, num_segments)
    return summed[:, :-2], summed[:, -2], summed[:, -1]


def _case(seed, W, S=3, b=16, n_real=600, n_pad=40, n_rows=150, long_runs=(0, 90, 700)):
    """A merge's inputs: ``n_real`` keys on ``n_rows`` unique rows, some of
    them empty, a few with ``long_runs`` keys each, then ``n_pad`` pad keys
    on the trash slot ``U_pad - 1``; pad keys carry the trash segment
    ``S * b`` and gradients that the mask must drop."""
    rng = np.random.default_rng(seed)
    U_pad = n_rows + 8
    used = rng.choice(n_rows, size=n_rows * 2 // 3, replace=False)  # the rest stay empty
    inv = rng.choice(used, size=n_real)
    for i, n in enumerate(long_runs):
        inv = np.concatenate([inv, np.full(n, used[i], inv.dtype)])
    inv = np.concatenate([rng.permutation(inv), np.full(n_pad, U_pad - 1)])
    L = len(inv)
    segments = np.concatenate([rng.integers(0, S * b, L - n_pad), np.full(n_pad, S * b)])
    gflat = rng.normal(size=(L, W)).astype(np.float32) * rng.choice([1e-3, 1.0, 50.0], size=(L, 1))
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt)  # noqa: E731
    return {
        "gflat": t(gflat, torch.float32),
        "segments": t(segments, torch.int32),
        "inverse": t(inv, torch.int32),
        "labels": t(rng.random(b) < 0.3, torch.float32),
        "ins_weight": t(rng.random(b) * (rng.random(b) > 0.2), torch.float32),
        "slot_lr": tuple(float(x) for x in rng.choice([0.5, 1.0, 2.5, 0.3], S)),
        "num_segments": U_pad,
        "S": S,
        "b": b,
    }


def _cfg(case, slot_lr):
    return TrainStepConfig(num_slots=case["S"], batch_size=case["b"], layout=ValueLayout(embedx_dim=4),
                           slot_lr=case["slot_lr"] if slot_lr else None)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().cpu().view(torch.int32).numpy()


def _same_bits(got, want):
    """Equal bits, and the same layout: what reads the views (the push's
    row reductions) must see the same strides."""
    for name, g, w in zip(("guniq", "show", "clk"), got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.stride() == w.stride(), name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


def _ref_args(case, with_w, with_lr, with_div, device="cpu"):
    dev = torch.device(device)
    order, offsets = ck.merge_order(case["inverse"].to(dev), case["num_segments"])
    args = (case["gflat"].to(dev), order, offsets, case["segments"].to(dev), case["labels"].to(dev), case["S"],
            case["b"])
    kw = {
        "ins_weight": case["ins_weight"].to(dev) if with_w else None,
        "slot_lr": torch.tensor(case["slot_lr"], dtype=torch.float32, device=dev) if with_lr else None,
        "grad_div": 3.0 if with_div else 1.0,
    }
    return args, kw


@pytest.mark.parametrize("W", [1, 13, 35, 131])
@pytest.mark.parametrize("with_w,with_lr,with_div", OPTIONS, ids=OPTION_IDS)
def test_plain_merge_is_the_former_merge_bit_for_bit(W, with_w, with_lr, with_div):
    case = _case(W * 7 + 1, W)
    cfg = _cfg(case, with_lr)
    w = case["ins_weight"] if with_w else None
    div = 3.0 if with_div else 1.0
    want = _former_merge(cfg, case["gflat"], case["segments"], case["inverse"], case["labels"],
                         case["num_segments"], ins_weight=w, grad_div=div)
    args, kw = _ref_args(case, with_w, with_lr, with_div)
    _same_bits(ck.merge_rows_ref(*args, **kw), want)
    # the step's entry, sorting for itself and with a feed's order
    got = train_step.scale_and_merge_grads(cfg, case["gflat"], case["segments"], case["inverse"], case["labels"],
                                           case["num_segments"], ins_weight=w, grad_div=div)
    _same_bits(got, want)
    got = train_step.scale_and_merge_grads(cfg, case["gflat"], case["segments"], case["inverse"], case["labels"],
                                           case["num_segments"], ins_weight=w, grad_div=div, order=args[1],
                                           offsets=args[2])
    _same_bits(got, want)


def test_merge_order_is_the_stable_sort_and_its_run_starts():
    case = _case(3, 13)
    order, offsets = ck.merge_order(case["inverse"], case["num_segments"])
    inv = case["inverse"].numpy()
    np.testing.assert_array_equal(order.numpy(), np.argsort(inv, kind="stable"))
    assert offsets.dtype == torch.int32
    counts = np.bincount(inv, minlength=case["num_segments"])
    np.testing.assert_array_equal(offsets.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    assert (counts == 0).any() and counts.max() > ck.MERGE_HEAVY_MIN  # empty runs and heavy ones


def test_merge_geometry_follows_the_width():
    assert [ck.merge_geometry(w)[:3] for w in (1, 5, 13, 16, 17, 35, 131, 300)] == [
        (1, 1, 1), (8, 1, 1), (16, 1, 1), (16, 1, 1), (32, 1, 1), (32, 2, 1), (32, 5, 1), (32, 8, 2)]
    slabs = [(g.min_slabs, g.max_slabs) for g in map(ck.merge_geometry, (13, 131, 256, 257, 7936))]
    assert slabs == [(1, 1), (1, 8), (1, 16), (2, 16), (31, 31)]
    with pytest.raises(ValueError, match="1 to 7936 columns"):
        ck.merge_geometry(7937)


def test_merge_kernel_refuses_cpu_tensors():
    before = dict(ck.launch_counts)
    case = _case(5, 13)
    args, kw = _ref_args(case, True, True, True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ck.merge_rows_cuda(*args, **kw)
    assert ck.launch_counts == before
    assert set(ck.launch_counts) == {"pull_rows_cuda", "write_rows_cuda", "merge_rows_cuda"}


# ---- the resident builder's order ---------------------------------------------


def _write_pass(path, n, max_len, seed, dense_dim=0):
    """``n`` records of ``len(max_len)`` slots, slot s holding 1..max_len[s]
    keys from its own small range (so rows repeat, some past the heavy
    cut), and a label; with ``dense_dim`` a dense slot too."""
    rng = np.random.default_rng(seed)
    with fs_open_write(path) as f:
        for _ in range(n):
            parts = [f"1 {float(rng.random() < 0.3):.1f}"]
            if dense_dim:
                parts.append(f"{dense_dim} " + " ".join(f"{v:.3f}" for v in rng.random(dense_dim) * 3))
            for s, m in enumerate(max_len):
                k = rng.integers(1, 30, rng.integers(1, m + 1)) + 1000 * (s + 1)
                parts.append(f"{len(k)} " + " ".join(str(x) for x in k))
            f.write(" ".join(parts) + "\n")


def _dataset(tmp_path, max_len, B, n_batches, seed, lay, dense_dim=0):
    path = str(tmp_path / f"part-{seed}.txt")
    _write_pass(path, B * n_batches, max_len, seed, dense_dim)
    S = len(max_len)
    slots = [SlotInfo("label", type="float", dense=True, dim=1)]
    if dense_dim:
        slots.append(SlotInfo("dense", type="float", dense=True, dim=dense_dim))
    schema = SlotSchema(slots + [SlotInfo(f"s{i}") for i in range(S)], label_slot="label")
    table = HostSparseTable(lay, SparseOptimizerConfig(embedx_threshold=0.0), n_shards=4, seed=seed)
    ds = BoxPSDataset(schema, table, batch_size=B, shuffle_mode="none")
    ds.set_filelist([path])
    ds.load_into_memory()
    ds.begin_pass(round_to=8)
    return ds


@pytest.mark.parametrize("max_len", [[3, 1, 9, 5], [1, 1, 1, 1, 1]], ids=["ragged_1_9", "one_key"])
def test_builder_order_is_argsort_of_inverse_and_its_runs(tmp_path, max_len):
    B, lay = 24, ValueLayout(embedx_dim=4)
    ds = _dataset(tmp_path, max_len, B, n_batches=3, seed=len(max_len), lay=lay)
    rp = ResidentPass(ds.store, ds.ws, ds.schema, torch.device("cpu"), bucket=16)
    blocks = [np.arange(i * B, (i + 1) * B, dtype=np.int32) for i in range(3)]
    rp.ensure(blocks)
    cfg = TrainStepConfig(num_slots=len(max_len), batch_size=B, layout=lay)
    rng = np.random.default_rng(0)
    for idx in blocks:
        batch = build_device_batch(rp, cfg, torch.from_numpy(idx))
        inv = batch["inverse"].numpy()
        order, offsets = batch["merge_order"], batch["merge_offsets"]
        assert order.dtype == torch.int64 and offsets.dtype == torch.int32
        np.testing.assert_array_equal(order.numpy(), np.argsort(inv, kind="stable"))
        counts = np.bincount(inv, minlength=rp.U_pad)
        assert len(counts) == rp.U_pad
        np.testing.assert_array_equal(offsets.numpy(), np.concatenate([[0], np.cumsum(counts)]))
        # the step's merge gives the same bits with the builder's order
        gflat = torch.from_numpy(rng.normal(size=(rp.L_pad, lay.pull_width)).astype(np.float32))
        args = (cfg, gflat, batch["segments"], batch["inverse"], batch["labels"], rp.U_pad)
        _same_bits(train_step.scale_and_merge_grads(*args, order=order, offsets=offsets),
                   _former_merge(*args))


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    """Skip the test where no CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("W", [13, 35, 131])
@pytest.mark.parametrize("with_w,with_lr,with_div", OPTIONS, ids=OPTION_IDS)
def test_kernel_is_the_plain_merge_bit_for_bit(card, W, with_w, with_lr, with_div):
    # long runs past the heavy cut, two of them split into column slabs at
    # PW 131, and many short ones
    case = _case(W * 11 + 2, W, S=5, b=512, n_real=60_000, n_pad=1500, n_rows=30_000,
                 long_runs=(0, 1, 33, 200, 5000, 9000))
    args, kw = _ref_args(case, with_w, with_lr, with_div, device="cuda")
    before = ck.launch_counts["merge_rows_cuda"]
    got = ck.merge_rows_cuda(*args, **kw)
    assert ck.launch_counts["merge_rows_cuda"] == before + 1
    want = ck.merge_rows_ref(*args, **kw)
    torch.cuda.synchronize()
    _same_bits(got, want)


@pytest.mark.card
@pytest.mark.parametrize("W", [1, 300])
def test_kernel_is_the_plain_merge_at_the_width_edges(card, W):
    """One lane a group (W = 1); two column slabs in both passes (W = 300)."""
    case = _case(W * 11 + 3, W, S=5, b=512, n_real=20_000, n_pad=700, n_rows=9_000, long_runs=(0, 40, 3000))
    args, kw = _ref_args(case, True, True, True, device="cuda")
    got = ck.merge_rows_cuda(*args, **kw)
    want = ck.merge_rows_ref(*args, **kw)
    torch.cuda.synchronize()
    _same_bits(got, want)


def _card_run(tmp_path, model_name, route, device):
    """One resident training step, then one eval step, of a small DLRM or
    DeepFM on ``device``: (table, params, [(the kernel's launches, the
    pass's AUC)] of the training step and of the eval step)."""
    S_len = {"dlrm": [3, 1, 9, 5], "deepfm": [1, 1, 1, 1, 1, 1]}[model_name]
    D, DD, B = 8, 13 if model_name == "dlrm" else 0, 512
    lay = ValueLayout(embedx_dim=D)
    ds = _dataset(tmp_path, S_len, B, n_batches=1, seed=9, lay=lay, dense_dim=DD)
    S = len(S_len)
    gen = torch.Generator().manual_seed(0)
    if model_name == "dlrm":
        model = DLRM(S, lay.pull_width, D, DD, bottom=[16, D], cross_layers=2, cross_rank=6, top=[24, 12],
                     generator=gen)
        extra = {"dense_slot": "dense", "dense_dim": DD}
    else:
        model = DeepFM(S, lay.pull_width, D, hidden=(32, 16), generator=gen)
        extra = {}
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(embedx_threshold=0.0),
                          auc_buckets=1000)
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-3), device=str(device), **extra)
    tr.init_params()
    counts = []
    with pytest.MonkeyPatch.context() as mp:
        if route == "plain":
            mp.setattr(train_step, "merge_rows_cuda", ck.merge_rows_ref)
        for test_mode in (False, True):
            tr.set_test_mode(test_mode)
            before = ck.launch_counts["merge_rows_cuda"]
            out = tr.train_pass(ds, n_batches=1)
            if device.type == "cuda":
                torch.cuda.synchronize()
            counts.append((ck.launch_counts["merge_rows_cuda"] - before, out["auc"]))
    assert tr.last_feed == "resident"
    return tr.trained_table_device().cpu(), {k: v.detach().cpu() for k, v in tr.params.items()}, counts


@pytest.mark.card
@pytest.mark.parametrize("model_name", ["dlrm", "deepfm"])
def test_resident_step_is_the_plain_route_bit_for_bit(tmp_path, card, model_name):
    table, params, counts = _card_run(tmp_path, model_name, "kernel", card)
    table0, params0, counts0 = _card_run(tmp_path, model_name, "plain", card)
    assert [c for c, _ in counts] == [1, 0]  # one launch a training step, none an eval step
    assert [c for c, _ in counts0] == [0, 0]
    np.testing.assert_array_equal(_bits(table), _bits(table0))
    assert sorted(params) == sorted(params0)
    for k in params:
        np.testing.assert_array_equal(_bits(params[k]), _bits(params0[k]), err_msg=k)
    assert [a for _, a in counts] == [a for _, a in counts0]


@pytest.mark.card
def test_push_merge_span_launches_only_the_merge_kernels(tmp_path, card):
    """Under the ``push_merge`` span of a traced resident step the card runs
    the merge's two kernels and the memset of their counters, and none of
    the former merge's concatenation, sort or segment reduction."""
    from bench_port.core import attribution

    lay = ValueLayout(embedx_dim=8)
    ds = _dataset(tmp_path, [3, 1, 9, 5], 512, n_batches=1, seed=11, lay=lay)
    cfg = TrainStepConfig(num_slots=4, batch_size=512, layout=lay,
                          sparse_opt=SparseOptimizerConfig(embedx_threshold=0.0), auc_buckets=1000)
    model = DeepFM(4, lay.pull_width, 8, hidden=(32, 16), generator=torch.Generator().manual_seed(0))
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-3), device="cuda")
    tr.init_params()
    tr.train_pass(ds, n_batches=1)  # builds and warms up
    _, events = attribution.profile(lambda: tr.train_pass(ds, n_batches=1))
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == "push_merge"]
    assert len(spans) == 1
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in attribution.LAUNCH_CATS and "correlation" in e.get("args", {})}
    under = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") in attribution.DEVICE_CATS
             and any(a <= launched.get(e.get("args", {}).get("correlation"), -1) < b for a, b in spans)]
    assert sum("merge_light_kernel" in n for n in under) == 1
    assert sum("merge_heavy_kernel" in n for n in under) == 1
    assert all("merge_light_kernel" in n or "merge_heavy_kernel" in n or "Memset" in n for n in under), under
