"""``mlp_apply``'s K padding: a layer whose input row in the compute dtype
is no whole number of 16 bytes runs its product, on a CUDA input, on
operands widened with zero columns.

The CPU tests hold the padding's arithmetic (the widths, and a product
and both gradients that gain only zeros) and hold ``mlp_apply`` on the
CPU to the bits of the unpadded formula. The test marked ``card`` runs
Wide&Deep's tower on a CUDA card and skips without one; it imports no JAX,
so the card's machine runs it with
``python -m pytest tests/test_torch_mlp_pad.py --noconftest -m card``.
"""

import pytest
import torch

from paddlebox_tpu_torch.models import layers
from paddlebox_tpu_torch.models.layers import CastPadK, aligned_width, mlp_apply, mlp_init

torch.set_num_threads(2)


@pytest.fixture
def card():
    """Skip the test where no CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _unpadded(mlp, x, compute_dtype=torch.bfloat16):
    """``mlp_apply(..., final_activation=True)`` as it ran before the
    padding: one cast, then every layer cast and multiplied at its own
    width."""
    h = x.to(compute_dtype)
    for lin in mlp:
        h = torch.relu(torch.matmul(h, lin.weight.to(compute_dtype).t()) + lin.bias.to(compute_dtype))
    return h.to(torch.float32)


@pytest.mark.parametrize(
    "k, dtype, want",
    [
        (507, torch.bfloat16, 512),  # DeepFM's tower input, 39 x 13
        (923, torch.bfloat16, 928),  # Wide&Deep's, 26 x 35 + 13
        (13, torch.bfloat16, 16),
        (512, torch.bfloat16, 512),  # already aligned: left alone
        (923, torch.float32, 924),
    ],
)
def test_aligned_width(k, dtype, want):
    assert aligned_width(k, dtype) == want


@pytest.mark.parametrize("k", [507, 923, 13, 512])
def test_padded_product_and_gradients_gain_only_zeros(k):
    """Small integers make every sum exact in fp32, so the padded product
    and both gradients equal the unpadded ones bit for bit, at the
    unpadded shapes."""
    gen = torch.Generator().manual_seed(k)
    x = torch.randint(-3, 4, (6, k), generator=gen).float().requires_grad_()
    w = torch.randint(-3, 4, (5, k), generator=gen).float().requires_grad_()
    g = torch.randint(-3, 4, (6, 5), generator=gen).float()
    k_pad = aligned_width(k, torch.bfloat16)

    xp, wp = CastPadK.apply(x, torch.float32, k_pad), CastPadK.apply(w, torch.float32, k_pad)
    assert xp.shape == (6, k_pad) and wp.shape == (5, k_pad)
    assert not xp[:, k:].any() and not wp[:, k:].any()
    got = torch.matmul(xp, wp.t())
    dx, dw = torch.autograd.grad(got, (x, w), g)

    want = torch.matmul(x, w.t())
    dx0, dw0 = torch.autograd.grad(want, (x, w), g)
    assert torch.equal(got, want)
    assert dx.shape == x.shape and dw.shape == w.shape
    assert torch.equal(dx, dx0) and torch.equal(dw, dw0)


def test_pad_in_its_own_dtype_returns_a_contiguous_gradient():
    """Under ``amp`` a weight arrives in bf16 already: its gradient comes
    back as a contiguous bf16 tensor of its own shape."""
    t = torch.randn(3, 5, dtype=torch.bfloat16, requires_grad=True)
    out = CastPadK.apply(t, torch.bfloat16, 8)
    assert out.dtype == torch.bfloat16 and out.shape == (3, 8)
    assert torch.equal(out[:, :5], t.detach())
    (grad,) = torch.autograd.grad(out, t, torch.arange(24, dtype=torch.bfloat16).reshape(3, 8))
    assert grad.dtype == torch.bfloat16 and grad.is_contiguous()
    assert torch.equal(grad, torch.arange(24, dtype=torch.bfloat16).reshape(3, 8)[:, :5])


@pytest.mark.parametrize("k", [507, 923, 13, 512])
def test_mlp_apply_on_the_cpu_keeps_its_bits(k):
    gen = torch.Generator().manual_seed(k)
    mlp = mlp_init(k, (16, 8), gen)
    x = torch.randn((32, k), generator=gen).requires_grad_()
    g = torch.randn((32, 8), generator=gen)
    before = layers.padded_products

    got = mlp_apply(mlp, x, final_activation=True)
    grads = torch.autograd.grad(got, (x, *mlp.parameters()), g)
    want = _unpadded(mlp, x)
    grads0 = torch.autograd.grad(want, (x, *mlp.parameters()), g)

    assert layers.padded_products == before
    assert torch.equal(got, want)
    for a, b in zip(grads, grads0):
        assert torch.equal(a, b)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.card
def test_widedeep_tower_runs_aligned_gemms_on_the_card(card):
    """Wide&Deep's tower (923 -> 1024-512-256) at a batch of 8,192 in bf16.

    The padded and the unpadded routes differ only in the order in which
    cuBLAS's kernels accumulate in fp32, which moves an element of a bf16
    result by at most one bf16 rounding where it lies near a rounding
    edge. Over a whole tensor that is well under bf16's epsilon (2^-7) in
    relative norm, the tolerance held here."""
    gen = torch.Generator().manual_seed(923)
    mlp = mlp_init(923, (1024, 512, 256), gen).to(card)
    x = torch.randn((8192, 923), generator=gen).to(card).requires_grad_()
    g = torch.randn((8192, 256), generator=gen).to(card)
    params = (x, *mlp.parameters())

    before = layers.padded_products
    got = mlp_apply(mlp, x, final_activation=True)
    assert layers.padded_products == before + 1
    grads = torch.autograd.grad(got, params, g)
    want = _unpadded(mlp, x)
    grads0 = torch.autograd.grad(want, params, g)

    assert _rel(got, want) < 2**-7
    for a, b, p in zip(grads, grads0, params):
        assert a.shape == p.shape and a.dtype == torch.float32
        assert _rel(a, b) < 2**-7

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(mlp_apply(mlp, x, final_activation=True), params, g)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names, "the profiler saw no kernel"
    assert not [n for n in names if "cutlass_75" in n or "s1688gemm" in n]
    assert layers.padded_products == before + 2
