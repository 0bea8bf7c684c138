"""The CONV / PCOC / per-slot-threshold seqpools, their CVM transforms,
``batch_fc`` and ``fused_concat`` against the JAX package's functions, on
``tests/test_ctr_ops.py``'s inputs and on wider random ones.

Tolerances: the seqpools sum each segment's keys in key order in both
packages and take the same logs, so they agree to rtol 1e-6 / atol 1e-6
(float32 ``log`` may round differently on the two backends' vector
paths); ``fused_concat`` is a copy (bitwise); ``batch_fc`` is a matmul,
whose CPU kernels sum in other orders: rtol 1e-5, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.ops import batch_fc as jbatch_fc
from paddlebox_tpu.ops import cvm_with_conv_transform as jconv_t
from paddlebox_tpu.ops import cvm_with_pcoc_transform as jpcoc_t
from paddlebox_tpu.ops import fused_concat as jfused_concat
from paddlebox_tpu.ops import fused_seqpool_cvm_with_conv as jconv
from paddlebox_tpu.ops import fused_seqpool_cvm_with_diff_thres as jdiff
from paddlebox_tpu.ops import fused_seqpool_cvm_with_pcoc as jpcoc
from paddlebox_tpu_torch.ops import (
    batch_fc,
    cvm_with_conv_transform,
    cvm_with_pcoc_transform,
    fused_concat,
    fused_seqpool_cvm_with_conv,
    fused_seqpool_cvm_with_diff_thres,
    fused_seqpool_cvm_with_pcoc,
)

torch.set_num_threads(2)

POOL_RTOL, POOL_ATOL = 1e-6, 1e-6
FC_RTOL, FC_ATOL = 1e-5, 1e-5


def _close(got: torch.Tensor, want, rtol=POOL_RTOL, atol=POOL_ATOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def _pool_inputs(seed, S, B, width, L, pads=0):
    """Non-negative records (counters stay counts) and segments in random
    order, with ``pads`` keys in the trash segment S * B."""
    rng = np.random.default_rng(seed)
    vals = np.abs(rng.normal(size=(L + pads, width))).astype(np.float32)
    segments = np.concatenate([rng.integers(0, S * B, L), np.full(pads, S * B)]).astype(np.int32)
    perm = rng.permutation(L + pads)
    return vals[perm], segments[perm]


@pytest.mark.parametrize("kw", [{}, {"show_filter": True}, {"use_cvm": False}, {"pad_value": 0.5}],
                         ids=["cvm", "show_filter", "no_cvm", "pad_value"])
@pytest.mark.parametrize("shape", [(2, 3, 2, 10, 0), (5, 16, 8, 200, 12)], ids=["test_ctr_ops", "wide"])
def test_seqpool_with_conv_matches_jax(kw, shape):
    S, B, D, L, pads = shape
    vals, seg = _pool_inputs(2, S, B, 3 + D, L, pads)
    got = fused_seqpool_cvm_with_conv(torch.from_numpy(vals), torch.from_numpy(seg), S, B, **kw)
    _close(got, jconv(jnp.asarray(vals), jnp.asarray(seg), S, B, **kw))


@pytest.mark.parametrize("kw", [{}, {"use_cvm": False}, {"quant_ratio": 128}, {"pad_value": 0.25}],
                         ids=["cvm", "no_cvm", "quant", "pad_value"])
@pytest.mark.parametrize("shape", [(1, 2, 2, 6, 0), (4, 16, 8, 150, 9)], ids=["test_ctr_ops", "wide"])
def test_seqpool_with_pcoc_matches_jax(kw, shape):
    S, B, D, L, pads = shape
    P = 3
    vals, seg = _pool_inputs(3, S, B, 4 + P + D, L, pads)
    got = fused_seqpool_cvm_with_pcoc(torch.from_numpy(vals), torch.from_numpy(seg), S, B, pclk_num=P, **kw)
    want = jpcoc(jnp.asarray(vals), jnp.asarray(seg), S, B, pclk_num=P, **kw)
    _close(got, want)
    if not kw:
        assert got.shape[-1] == 2 + 2 * P + D


def test_seqpool_diff_thres_per_slot_filter_matches_jax():
    """``tests/test_ctr_ops.py``'s case: slot 0's key passes its threshold,
    slot 1's fails its higher one."""
    S, B = 2, 1
    vals = np.array([[1.0, 1.0, 5.0], [1.0, 1.0, 7.0]], np.float32)
    seg = np.array([0, 1], np.int32)
    thr = np.array([0.5, 99.0], np.float32)
    got = fused_seqpool_cvm_with_diff_thres(
        torch.from_numpy(vals), torch.from_numpy(seg), S, B, threshold_vec=thr, show_coeff=0.2, clk_coeff=1.0
    )
    _close(got, jdiff(jnp.asarray(vals), jnp.asarray(seg), S, B, threshold_vec=thr, show_coeff=0.2, clk_coeff=1.0))
    assert float(got[0, 0, 2]) == 5.0 and float(got[0, 1, 2]) == 0.0


@pytest.mark.parametrize("kw", [{}, {"clk_filter": True}, {"use_cvm": False, "quant_ratio": 64},
                                {"pad_value": 1.0}], ids=["cvm", "clk_filter", "quant", "pad_value"])
def test_seqpool_diff_thres_wide_matches_jax(kw):
    """Per-slot thresholds over a wide random batch with pads: the trash
    segment's keys take the last slot's threshold, as in JAX, and drop."""
    S, B, D = 6, 12, 8
    vals, seg = _pool_inputs(4, S, B, 3 + D, 300, 10)
    vals[:, 1] = np.minimum(vals[:, 1], vals[:, 0])  # clk <= show
    thr = np.linspace(0.05, 0.6, S).astype(np.float32)
    got = fused_seqpool_cvm_with_diff_thres(torch.from_numpy(vals), torch.from_numpy(seg), S, B, thr, **kw)
    _close(got, jdiff(jnp.asarray(vals), jnp.asarray(seg), S, B, thr, **kw))


def test_conv_pcoc_transforms_match_jax():
    """``tests/test_ctr_ops.py``'s shapes, and the values on random pooled
    counters."""
    rng = np.random.default_rng(5)
    x = np.abs(rng.normal(size=(2, 2, 7))).astype(np.float32)
    for kw in ({}, {"show_filter": True}, {"use_cvm": False}):
        _close(cvm_with_conv_transform(torch.from_numpy(x), **kw), jconv_t(jnp.asarray(x), **kw))
    assert tuple(cvm_with_conv_transform(torch.ones((2, 2, 7))).shape) == (2, 2, 7)
    assert tuple(cvm_with_conv_transform(torch.ones((2, 2, 7)), show_filter=True).shape) == (2, 2, 6)
    y = np.abs(rng.normal(size=(2, 2, 4 + 3 + 2))).astype(np.float32)
    for kw in ({"pclk_num": 3}, {"pclk_num": 3, "use_cvm": False}, {"pclk_num": 1}):
        _close(cvm_with_pcoc_transform(torch.from_numpy(y), **kw), jpcoc_t(jnp.asarray(y), **kw))
    assert tuple(cvm_with_pcoc_transform(torch.ones((2, 2, 9)), pclk_num=3).shape) == (2, 2, 2 + 6 + 2)


@pytest.mark.parametrize("dims", [(5, 3, 4, 2), (64, 39, 11, 8)], ids=["test_ctr_ops", "wide"])
def test_batch_fc_matches_jax_and_the_channel_loop(dims):
    B, cnt, fin, fout = dims
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, cnt * fin)).astype(np.float32)
    w = rng.normal(size=(fin, cnt * fout)).astype(np.float32)
    b = rng.normal(size=(cnt * fout,)).astype(np.float32)
    got = batch_fc(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), cnt)
    _close(got, jbatch_fc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), cnt), FC_RTOL, FC_ATOL)
    for k in range(cnt):
        want = x[:, k * fin : (k + 1) * fin] @ w[:, k * fout : (k + 1) * fout] + b[k * fout : (k + 1) * fout]
        np.testing.assert_allclose(got[:, k * fout : (k + 1) * fout].numpy(), want, rtol=FC_RTOL, atol=FC_ATOL)


def test_batch_fc_gradients_match_the_channel_loop():
    """The autograd backward of the batched product: each channel's
    gradient is its own FC's."""
    B, cnt, fin, fout = 6, 3, 4, 2
    g = torch.Generator().manual_seed(0)
    x = torch.randn((B, cnt * fin), generator=g, requires_grad=True)
    w = torch.randn((fin, cnt * fout), generator=g, requires_grad=True)
    b = torch.randn((cnt * fout,), generator=g, requires_grad=True)
    torch.sum(batch_fc(x, w, b, cnt) ** 2).backward()
    x2, w2, b2 = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    out = torch.cat([x2[:, k * fin : (k + 1) * fin] @ w2[:, k * fout : (k + 1) * fout] + b2[k * fout : (k + 1) * fout]
                     for k in range(cnt)], dim=1)
    torch.sum(out**2).backward()
    for a, c in ((x, x2), (w, w2), (b, b2)):
        torch.testing.assert_close(a.grad, c.grad, rtol=FC_RTOL, atol=FC_ATOL)


def test_fused_concat_matches_jax():
    xs = [np.arange(12.0, dtype=np.float32).reshape(3, 4), 100 + np.arange(12.0, dtype=np.float32).reshape(3, 4)]
    got = fused_concat([torch.from_numpy(x) for x in xs], offset=1, length=2)
    want = np.asarray(jfused_concat([jnp.asarray(x) for x in xs], offset=1, length=2))
    assert got.numpy().tobytes() == want.tobytes()
    np.testing.assert_array_equal(got[0].numpy(), [1, 2, 101, 102])
    rng = np.random.default_rng(6)
    ys = [rng.normal(size=(16, 21)).astype(np.float32) for _ in range(39)]
    got = fused_concat([torch.from_numpy(y) for y in ys], offset=5, length=16)
    assert got.numpy().tobytes() == np.asarray(jfused_concat([jnp.asarray(y) for y in ys], 5, 16)).tobytes()
