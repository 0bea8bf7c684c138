"""The port's DLRM-DCNv2 against the benchmark's plain fp32 reference
(``bench_port/reference/dlrm.py``), on the CPU at a small size.

The model has no JAX counterpart, so the reference is the benchmark's.
Compared with the port's products in fp32 (the tests swap the tower's
compute dtype): the logits and every parameter's gradient within fp32
rounding (rtol 1e-5, atol 1e-6 of the leaf's largest element), one cross
layer against its formula, and two ``train_pass`` steps of a multi-hot pass (per-sample slot lengths 1-9,
a 13-wide dense slot) through ``CTRTrainer``'s resident feed against the
reference's multi-hot trainer: the losses and preds, the pass's table rows
(embedx, both g2 sums, show, clk) and the dense params. Adam's first steps
move a weight by about lr times its gradient's sign, so a param whose
gradient rounding can flip is held to 2 lr a step (see
``test_torch_zoo.py``); the rest agree within 1e-5. The spans of the model
and the shared seqpool and push merge come once a step, and the ``pooled_keys`` counter
counts the batches' keys.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import pytest
import torch

import paddlebox_tpu_torch.models.dlrm as dlrm
import paddlebox_tpu_torch.models.layers as layers
from bench_port.reference import dlrm as ref
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.models import DLRM
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig, resident_step
from paddlebox_tpu_torch.utils.fs import fs_open_write
from paddlebox_tpu_torch.utils.trace import PROFILER

torch.set_num_threads(2)

S, D, DD, B = 4, 8, 13, 32
MAX_LEN = [3, 1, 9, 5]  # each slot's most keys; a sample holds 1..MAX_LEN[s]
CFG = {
    "num_slots": S, "dense_dim": DD, "embedx_dim": D, "bottom_mlp": [16, D], "cross_layers": 2, "cross_rank": 6,
    "top_mlp": [24, 12], "multi_hot_sizes": MAX_LEN, "dense_lr": 1e-3, "auc_buckets": 100,
    "sparse_opt": {"embed_lr": 0.05, "embedx_lr": 0.05, "initial_g2sum": 3.0, "embedx_threshold": 2.0,
                   "weight_bounds": 10.0, "show_clk_decay": 0.98, "shrink_threshold": 1.0},
}
LAY = ValueLayout(embedx_dim=D)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def fp32_tower(monkeypatch):
    """The port's bottom, cross and top products in fp32."""
    monkeypatch.setattr(dlrm, "mlp_apply", functools.partial(layers.mlp_apply, compute_dtype=torch.float32))
    monkeypatch.setattr(dlrm, "product", lambda x, w, dtype: layers.product(x, w, torch.float32))


def _model() -> DLRM:
    return DLRM(S, LAY.pull_width, D, DD, bottom=CFG["bottom_mlp"], cross_layers=CFG["cross_layers"],
                cross_rank=CFG["cross_rank"], top=CFG["top_mlp"], generator=torch.Generator().manual_seed(0))


def _weights(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(s, generator=g) * (0.3 if len(s) == 2 else 0.05) for n, s in ref.param_shapes(CFG)}


def test_param_names_and_shapes_are_the_references():
    got = {k: tuple(v.shape) for k, v in _model().state_dict().items()}
    assert got == dict(ref.param_shapes(CFG))


def test_published_widths():
    m = DLRM(26, 131, 128, 13, generator=torch.Generator().manual_seed(0))
    assert [lin.out_features for lin in m.bottom] == [512, 256, 128]
    assert [(c.V.weight.shape, c.W.weight.shape) for c in m.cross] == [((512, 3456), (3456, 512))] * 3
    assert [lin.out_features for lin in m.top] == [1024, 1024, 512, 256] and m.out.out_features == 1
    assert m.cross[0].V.bias is None


def test_forward_and_gradients_match_the_reference(fp32_tower):
    w = _weights(1)
    g = torch.Generator().manual_seed(2)
    feats = torch.randn((B, S, LAY.pull_width), generator=g)
    dense = torch.rand((B, DD), generator=g) * 3
    model = _model()
    model.load_state_dict(w)
    got = model(feats, dense)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want = ref.forward(p, feats, dense)
    torch.testing.assert_close(got, want.detach(), rtol=RTOL, atol=ATOL)
    got.square().sum().backward()
    want.square().sum().backward()
    params = dict(model.named_parameters())
    for k in w:  # an element's rounding is of its leaf's scale
        scale = float(p[k].grad.abs().max())
        torch.testing.assert_close(params[k].grad, p[k].grad, rtol=RTOL, atol=ATOL * scale, msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_cross_layer_is_its_formula(dtype):
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn((7, 24), generator=g)
    v, w, b = torch.randn((5, 24), generator=g), torch.randn((24, 5), generator=g), torch.randn((24,), generator=g)
    got = dlrm.cross_apply(x0, v, w, b, compute_dtype=dtype)
    u = (x0.to(dtype) @ v.to(dtype).t()).to(dtype)
    want = x0 * ((u @ w.to(dtype).t()).float() + b) + x0
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---- two train_pass steps on a multi-hot pass -------------------------------


def _pass(tmp_path, n: int, seed: int):
    """A pass of ``n`` records: keys [n, sum(MAX_LEN)] (0 where a sample
    holds fewer), labels, dense; and its file."""
    rng = np.random.default_rng(seed)
    K = sum(MAX_LEN)
    keys = np.zeros((n, K), np.uint64)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    dense = np.round(rng.random((n, DD)) * 4, 3).astype(np.float32)
    lines, c0 = [[] for _ in range(n)], 0
    for s, m in enumerate(MAX_LEN):
        lens = rng.integers(1, m + 1, n)
        for i in range(n):
            k = rng.integers(1, 40, lens[i]) + 1000 * (s + 1)  # slot s's own keys, some repeated
            keys[i, c0 : c0 + lens[i]] = k
            lines[i].append(f"{lens[i]} " + " ".join(str(x) for x in k))
        c0 += m
    path = str(tmp_path / "part-000.txt")
    with fs_open_write(path) as f:
        for i in range(n):
            values = " ".join(f"{v:.3f}" for v in dense[i])
            f.write(f"1 {labels[i]:.1f} {DD} {values} " + " ".join(lines[i]) + "\n")
    return keys, labels, dense, path


def _train(tmp_path, steps: int = 2, spans: bool = False):
    keys, labels, dense, path = _pass(tmp_path, B * steps, seed=4)
    uniq = np.unique(keys[keys != 0])
    rg = np.random.default_rng(5)
    rows = np.zeros((len(uniq), LAY.width), np.float32)
    rows[:, 0] = rg.integers(0, 5, len(uniq))  # show around the embedx threshold of 2
    rows[:, 1] = np.floor(rows[:, 0] * rg.random(len(uniq)) * 0.5)
    rows[:, 2 : 3 + D] = rg.normal(0, 0.1, (len(uniq), 1 + D))
    opt = SparseOptimizerConfig(**CFG["sparse_opt"])
    table = HostSparseTable(LAY, opt, n_shards=4, seed=0)
    table.push(uniq, rows)
    schema = SlotSchema([SlotInfo("label", type="float", dense=True, dim=1),
                         SlotInfo("dense", type="float", dense=True, dim=DD)] + [SlotInfo(f"s{i}") for i in range(S)],
                        label_slot="label")
    ds = BoxPSDataset(schema, table, batch_size=B, shuffle_mode="none")
    ds.set_filelist([path])
    ds.load_into_memory()
    ds.begin_pass(round_to=8)
    w = _weights(6)
    model = _model()
    model.load_state_dict(w)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=LAY, sparse_opt=opt, auc_buckets=CFG["auc_buckets"])
    tr = CTRTrainer(model, cfg, dense_opt=Adam(CFG["dense_lr"]), device="cpu", dense_slot="dense", dense_dim=DD)
    tr.init_params()
    out = {"losses": [], "preds": []}

    def on_batch(i, m):
        out["losses"].append(float(m["loss"]))
        out["preds"].append(m["preds"].detach().numpy().copy())

    keys0 = resident_step.pooled_keys
    if spans:
        PROFILER.reset()
        PROFILER.enable()
    try:
        tr.train_pass(ds, n_batches=steps, on_batch=on_batch)
    finally:
        PROFILER.disable()
    assert tr.last_feed == "resident"
    out["pooled_keys"] = resident_step.pooled_keys - keys0
    out["spans"] = collections.Counter(e["name"] for e in PROFILER._events)
    PROFILER.reset()
    ws = ds.ws
    pos = np.searchsorted(ws.sorted_keys, uniq)
    out["rows"] = tr.trained_table_device()[torch.from_numpy(ws.row_of_sorted[pos].astype(np.int64))]
    out["params"] = {k: v.detach().clone() for k, v in tr.params.items()}
    batches = [{"keys": keys[i * B : (i + 1) * B], "labels": labels[i * B : (i + 1) * B],
                "dense": dense[i * B : (i + 1) * B]} for i in range(steps)]
    return out, uniq, torch.from_numpy(rows), w, batches


def test_two_train_pass_steps_match_the_multihot_reference(tmp_path, fp32_tower):
    prog, uniq, rows0, w, batches = _train(tmp_path)
    rt = ref.MultiHotTrainer(ref, CFG, uniq, rows0, w)
    for i, b in enumerate(batches):
        loss, preds = rt.step(b["keys"], torch.from_numpy(b["labels"]), torch.from_numpy(b["dense"]))
        assert prog["losses"][i] == pytest.approx(loss, rel=RTOL)
        np.testing.assert_allclose(prog["preds"][i], preds.numpy(), rtol=RTOL, atol=ATOL)
    got, want = prog["rows"], rt.table
    for name, cols in (("show", [0]), ("clk", [1]), ("embed_w", [2]), ("embedx", list(range(3, 3 + D))),
                       ("g2 sums", [3 + D, 4 + D])):
        torch.testing.assert_close(got[:, cols], want[:, cols], rtol=RTOL, atol=ATOL, msg=name)
    assert torch.any(got[:, 3 : 3 + D] != rows0[:, 3 : 3 + D])  # the embeddings trained
    assert torch.all(got[:, 2] == rows0[:, 2])  # the model reads no embed_w
    lr = CFG["dense_lr"]
    for k, v in rt.params.items():
        diff = (prog["params"][k] - v).abs()
        assert float(diff.max()) <= 2 * lr * len(batches) + ATOL, k
        assert float((diff > 1e-5).float().mean()) < 0.01, k


def test_model_and_seqpool_spans_and_the_pooled_keys(tmp_path):
    steps = 2
    prog, _, _, _, batches = _train(tmp_path, steps=steps, spans=True)
    for name in ("dlrm.bottom", "dlrm.cross", "dlrm.cross.bwd", "dlrm.top", "seqpool", "seqpool.bwd", "push_merge"):
        assert prog["spans"][name] == steps, name
    assert prog["pooled_keys"] == sum(int(np.count_nonzero(b["keys"])) for b in batches)
