"""The port's fused seqpool+CVM and online AUC against the JAX package.

Seqpool+CVM: rtol 1e-5 (atol 1e-6 for values near zero). Both sum each
segment's keys in key order in fp32, so the sums agree to rounding; the
logs and the quant round follow the same formulas. AUC: the bucket tables
must be exact and the metric dicts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.metrics.auc import AUC_BUCKET_CAP as JAUC_BUCKET_CAP
from paddlebox_tpu.metrics.auc import AucState as JAucState
from paddlebox_tpu.metrics.auc import auc_compute as jauc_compute
from paddlebox_tpu.metrics.auc import auc_update as jauc_update
from paddlebox_tpu.ops.seqpool_cvm import fused_seqpool_cvm as jfused_seqpool_cvm
from paddlebox_tpu_torch.metrics.auc import AUC_BUCKET_CAP, AucState, auc_compute, auc_init, auc_update
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm

torch.set_num_threads(2)

S, B, W = 5, 8, 7


def _seqpool_inputs(seed):
    """Pulled records and packer-style segments: non-decreasing, some
    (slot, ins) pairs empty, pads at the tail in the trash segment S*B."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 4, S * B)
    lens[::5] = 0
    segments = np.repeat(np.arange(S * B, dtype=np.int32), lens)
    segments = np.concatenate([segments, np.full(9, S * B, dtype=np.int32)])
    L = len(segments)
    records = rng.normal(size=(L, W)).astype(np.float32)
    show = rng.integers(0, 20, L).astype(np.float32)
    records[:, 0] = show
    records[:, 1] = np.floor(show * rng.random(L)).astype(np.float32)
    return records, segments


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"use_cvm": False},
        {"clk_filter": True},
        {"pad_value": 0.25},
        {"need_filter": True, "show_coeff": 0.2, "clk_coeff": 1.0, "threshold": 0.96},
        {"quant_ratio": 128},
        {"pad_value": -1.5, "need_filter": True, "quant_ratio": 64, "clk_filter": True},
    ],
)
def test_fused_seqpool_cvm_matches_jax(kw):
    records, segments = _seqpool_inputs(len(kw))
    want = np.asarray(
        jfused_seqpool_cvm(jnp.asarray(records), jnp.asarray(segments), S, B, **kw)
    )
    got = fused_seqpool_cvm(
        torch.from_numpy(records), torch.from_numpy(segments), S, B, **kw
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fused_seqpool_cvm_reruns_bitwise():
    records, segments = _seqpool_inputs(11)
    a = fused_seqpool_cvm(torch.from_numpy(records), torch.from_numpy(segments), S, B)
    b = fused_seqpool_cvm(torch.from_numpy(records), torch.from_numpy(segments), S, B)
    assert torch.equal(a, b)


def _run_both(jstate, state, preds, labels, mask):
    jstate = jauc_update(
        jstate, jnp.asarray(preds), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask),
    )
    state = auc_update(
        state, torch.from_numpy(preds), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask),
    )
    return jstate, state


@pytest.mark.parametrize("with_mask", [False, True])
def test_auc_tables_exact_and_metrics_equal(with_mask):
    rng = np.random.default_rng(5)
    n_buckets = 1000
    jstate = JAucState(jnp.zeros(n_buckets, jnp.int32), jnp.zeros(n_buckets, jnp.int32))
    state = auc_init(n_buckets, device="cpu")
    for _ in range(3):
        preds = rng.random(256).astype(np.float32)
        preds[:3] = [0.0, 1.0, 0.9999999]  # both clip edges
        labels = (rng.random(256) < preds).astype(np.float32)
        mask = (rng.random(256) < 0.8) if with_mask else None
        jstate, state = _run_both(jstate, state, preds, labels, mask)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_array_equal(state.neg.numpy(), np.asarray(jstate.neg))
    assert auc_compute(state) == jauc_compute(jstate)


def test_auc_saturates_at_cap_like_jax():
    assert int(AUC_BUCKET_CAP) == int(JAUC_BUCKET_CAP)
    near = np.full(4, int(AUC_BUCKET_CAP) - 2, dtype=np.int32)
    jstate = JAucState(jnp.asarray(near), jnp.asarray(near))
    state = AucState(torch.from_numpy(near.copy()), torch.from_numpy(near.copy()))
    preds = np.full(8, 0.6, dtype=np.float32)
    labels = np.ones(8, dtype=np.float32)
    jstate, state = _run_both(jstate, state, preds, labels, None)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    assert int(state.pos[2]) == int(AUC_BUCKET_CAP)
    assert auc_compute(state) == jauc_compute(jstate)
    assert auc_compute(state)["saturated"] == 1.0


# ---- sparse push ----------------------------------------------------------
#
# sparse_update_rows: rtol 1e-6, atol 1e-7. Both packages run the same f32
# formulas elementwise; XLA fuses and reorders some of them, so a few
# elements round differently (measured max |diff| 6.0e-8 at these sizes).
# push_sparse_rows: the JAX package's push off the TPU adds each row's delta
# (table.at[rows].add(new - old)); the port writes the new rows when keys
# are deduplicated, so old + (new - old) and new may differ by one rounding
# (same tolerance); without dedup both add the deltas in row order.

from paddlebox_tpu.ops.pull_push import push_sparse_rows as jpush_sparse_rows  # noqa: E402
from paddlebox_tpu.ops.pull_push import sparse_update_rows as jsparse_update_rows  # noqa: E402
from paddlebox_tpu.table.optimizers import SparseOptimizerConfig as JSparseOptimizerConfig  # noqa: E402
from paddlebox_tpu.table.value_layout import FeatureType as JFeatureType  # noqa: E402
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout  # noqa: E402
from paddlebox_tpu_torch import config  # noqa: E402
from paddlebox_tpu_torch.ops.pull_push import push_sparse_rows, sparse_update_rows  # noqa: E402
from paddlebox_tpu_torch.table.optimizers import SparseOptimizerConfig  # noqa: E402
from paddlebox_tpu_torch.table.value_layout import FeatureType, ValueLayout  # noqa: E402

PUSH_RTOL, PUSH_ATOL = 1e-6, 1e-7


def _push_inputs(seed, lay, n_rows, U, unique=True):
    rng = np.random.default_rng(seed)
    table = (0.5 * rng.normal(size=(n_rows, lay.width))).astype(np.float32)
    table[:, lay.SHOW] = rng.integers(0, 60, n_rows)
    table[:, lay.CLK] = np.floor(table[:, lay.SHOW] * 0.3)
    table[:, lay.embed_g2_col :] = rng.random((n_rows, lay.width - lay.embed_g2_col))
    table[:, 2] = 9.99  # near the weight bound: the clip bites
    if unique:
        rows = rng.permutation(n_rows - 1)[:U].astype(np.int32)
        rows[-3:] = n_rows - 1  # padding-row repeats carry zero records
    else:
        rows = rng.integers(0, n_rows, U).astype(np.int32)
        rows[::4] = rows[0]  # a key occurring in several slots
    grads = rng.normal(size=(U, lay.pull_width)).astype(np.float32)
    show = rng.integers(1, 4, U).astype(np.float32)
    clk = np.floor(show * rng.random(U)).astype(np.float32)
    if unique:
        grads[-3:] = 0.0
        show[-3:] = 0.0
        clk[-3:] = 0.0
    lr_scale = rng.uniform(0.5, 2.0, U).astype(np.float32)
    return table, rows, grads, show, clk, lr_scale


def _layouts(feature_type):
    return (
        ValueLayout(embedx_dim=8, feature_type=feature_type),
        JValueLayout(embedx_dim=8, feature_type=JFeatureType(feature_type.value)),
    )


@pytest.mark.parametrize("feature_type", [FeatureType.PLAIN, FeatureType.VARIABLE])
@pytest.mark.parametrize("per_row_lr", [False, True])
def test_sparse_update_rows_matches_jax(feature_type, per_row_lr):
    lay, jlay = _layouts(feature_type)
    opt = SparseOptimizerConfig(embedx_threshold=8.0, weight_bounds=10.0)
    jopt = JSparseOptimizerConfig(embedx_threshold=8.0, weight_bounds=10.0)
    table, rows, grads, show, clk, lr = _push_inputs(3, lay, 80, 40)
    old = table[rows]
    lr_j = jnp.asarray(lr) if per_row_lr else 0.7
    lr_t = torch.from_numpy(lr) if per_row_lr else 0.7
    want = np.asarray(
        jsparse_update_rows(
            jnp.asarray(old), jnp.asarray(grads), jnp.asarray(show), jnp.asarray(clk),
            jlay, jopt, lr_j,
        )
    )
    got = sparse_update_rows(
        torch.from_numpy(old), torch.from_numpy(grads), torch.from_numpy(show),
        torch.from_numpy(clk), lay, opt, lr_t,
    ).numpy()
    assert got.shape == (40, lay.width)
    np.testing.assert_allclose(got, want, rtol=PUSH_RTOL, atol=PUSH_ATOL)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("feature_type", [FeatureType.PLAIN, FeatureType.VARIABLE])
@pytest.mark.parametrize("per_row_lr", [False, True])
def test_push_sparse_rows_matches_jax(dedup, feature_type, per_row_lr):
    lay, jlay = _layouts(feature_type)
    opt = SparseOptimizerConfig(embedx_threshold=8.0)
    jopt = JSparseOptimizerConfig(embedx_threshold=8.0)
    table, rows, grads, show, clk, lr = _push_inputs(5, lay, 64, 32, unique=dedup)
    lr_j = jnp.asarray(lr) if per_row_lr else 1.3
    lr_t = torch.from_numpy(lr) if per_row_lr else 1.3
    want = np.asarray(
        jpush_sparse_rows(
            jnp.asarray(table), jnp.asarray(rows), jnp.asarray(grads), jnp.asarray(show),
            jnp.asarray(clk), jlay, jopt, lr_j,
        )
    )
    t = torch.from_numpy(table.copy())
    config.set_flag("enable_pullpush_dedup_keys", dedup)
    try:
        out = push_sparse_rows(
            t, torch.from_numpy(rows), torch.from_numpy(grads), torch.from_numpy(show),
            torch.from_numpy(clk), lay, opt, lr_t,
        )
    finally:
        config.set_flag("enable_pullpush_dedup_keys", True)
    assert out is t  # in place
    np.testing.assert_allclose(t.numpy(), want, rtol=PUSH_RTOL, atol=PUSH_ATOL)
    untouched = np.setdiff1d(np.arange(64), rows)
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])
    if dedup:  # zero records leave the padding row as it was
        np.testing.assert_array_equal(t.numpy()[63], table[63])
