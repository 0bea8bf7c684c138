"""The port's sequence parallelism (``parallel/ring_attention.py``,
``MeshPlan.tiled_all_to_all``) against the JAX package's
``parallel/ring_attention.py``.

The port runs in one gloo world of 4 CPU ranks, spawned once for the
module; the ranks write their results to ``.npz`` files. The JAX side
runs the JAX functions under ``shard_map`` on 4 of the suite's 8 virtual
CPU devices (``make_mesh(4, axis="sp")``). The inputs come from numpy
seeds. Held here:

- every case of ``tests/test_ring_attention.py`` at its bounds: ring and
  Ulysses, causal or not, against full attention and the JAX function
  (rtol 2e-4 / atol 2e-5); ring's grads of ``sum(out)`` (rtol 5e-4 /
  atol 5e-5); the heads' divisibility; bf16 inputs (bf16 out, under 0.02
  of fp32 full attention);
- Ulysses' grads, and ring's without the mask, at the same grad bounds;
- ``_flash_local``'s chunk rule at a global S of 1,536 (3 chunks of 512)
  and 1,200 (3 of 400);
- ``remat``: no ``[S_local, S_local]`` (ring) or ``[S_global, chunk]``
  (Ulysses) block saved for the backward, one saved without it, and the
  grads bitwise alike;
- a forward and backward's collectives on every rank, the tiled
  all_to_all's block order and gradient against ``lax.all_to_all``, and
  the device rule.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.fleet.launch import spawn
from paddlebox_tpu_torch.parallel import MeshPlan, make_mesh, ring_attention, ulysses_attention
from paddlebox_tpu_torch.parallel.ring_attention import _chunk_size

torch.set_num_threads(2)

N = 4
B, S_LOC, H, D = 2, 8, 8, 16  # global seq = 32, as tests/test_ring_attention.py's
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
BF16_MAX_ERR = 0.02
CHUNK_S = (1536, 1200)  # global S of the chunking cases: 3 chunks of 512, 3 of 400
CHUNK_H, CHUNK_D = 4, 8
REMAT = (2, 12, 4, 16)  # B, S_local, H, D: distinct from each other and from the chunk (48)
A2A = (2, 8, 12, 3)  # the tiled all_to_all's local block: heads 12 split over 4 ranks
IMPLS = ("ring", "ulysses")
CALLS = ("shift", "all_to_all", "all_reduce", "all_gather", "broadcast")
# one forward and backward: ring 2 (n - 1) shifts, Ulysses 2 all_to_alls each way
WANT_CALLS = {"ring": {"shift": 2 * (N - 1)}, "ulysses": {"all_to_all": 4}}


def _fns():
    return {"ring": ring_attention, "ulysses": ulysses_attention}


def make_inputs():
    """Every case's global [B, S, H, D] arrays, from numpy seeds."""
    out = {}

    def mk(rng, shape):
        return rng.normal(size=shape).astype(np.float32)

    for tag, seed in (("fwd", 0), ("grad", 1), ("bf16", 3)):
        rng = np.random.default_rng(seed)
        for x in "qkv":
            out[f"{tag}:{x}"] = mk(rng, (B, S_LOC * N, H, D))
    for s in CHUNK_S:
        rng = np.random.default_rng(s)
        for x in "qkv":
            out[f"chunk{s}:{x}"] = mk(rng, (1, s, CHUNK_H, CHUNK_D))
    rng = np.random.default_rng(5)
    rb, rs, rh, rd = REMAT
    for x in "qkv":
        out[f"remat:{x}"] = mk(rng, (rb, rs * N, rh, rd))
    rng = np.random.default_rng(6)
    out["a2a:x"] = mk(rng, (A2A[0], A2A[1] * N, A2A[2], A2A[3]))
    out["a2a:w"] = mk(rng, (A2A[0], A2A[1] * N, A2A[2], A2A[3]))
    return out


# ---- the ranks ------------------------------------------------------------------


def _local(data, key, r, dim=1):
    x = data[key]
    s = x.shape[dim] // N
    return torch.from_numpy(np.ascontiguousarray(np.take(x, range(r * s, (r + 1) * s), axis=dim)))


def _qkv(data, tag, r, dtype=torch.float32, grad=False):
    return [_local(data, f"{tag}:{x}", r).to(dtype).requires_grad_(grad) for x in "qkv"]


def _grads(fn, sp, qkv, causal, remat=True, record=None):
    """(dq, dk, dv) of sum(out) on this rank, and the forward and
    backward's collectives; ``record`` collects the shapes of the tensors
    the forward saves for the backward."""
    sp.reset_calls()
    if record is None:
        o = fn(*qkv, sp, causal=causal, remat=remat)
    else:
        def pack(t):
            record.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            o = fn(*qkv, sp, causal=causal, remat=remat)
    o.sum().backward()
    return [x.grad.numpy() for x in qkv], np.array([sp.calls[k] for k in CALLS])


def rank_main(plan, in_path, out_dir):
    data = dict(np.load(in_path))
    sp = make_mesh(plan.backend, device=plan.device, axis="sp")
    r, out, fns = sp.rank, {}, _fns()
    for impl, fn in fns.items():
        for causal in (False, True):
            # the default axis here, axis_name on the world's own "dp" plan below
            out[f"fwd:{impl}:{causal}"] = fn(*_qkv(data, "fwd", r), sp, causal=causal).numpy()
            qkv = _qkv(data, "grad", r, grad=True)
            (dq, dk, dv), out[f"calls:{impl}:{causal}"] = _grads(fn, sp, qkv, causal)
            out[f"grad:{impl}:{causal}:q"], out[f"grad:{impl}:{causal}:k"], out[f"grad:{impl}:{causal}:v"] = dq, dk, dv
        got = fn(*_qkv(data, "bf16", r, torch.bfloat16), plan, axis_name="dp", causal=True)
        out[f"bf16:{impl}:dtype"] = np.array(str(got.dtype))
        out[f"bf16:{impl}"] = got.float().numpy()
        for remat in (True, False):
            shapes = []
            g, _ = _grads(fn, sp, _qkv(data, "remat", r, grad=True), True, remat=remat, record=shapes)
            out[f"remat:{impl}:{remat}:shapes"] = np.array(sorted(set(shapes)), dtype=object)
            for x, gx in zip("qkv", g):
                out[f"remat:{impl}:{remat}:{x}"] = gx
    for s in CHUNK_S:
        out[f"chunk{s}"] = ulysses_attention(*_qkv(data, f"chunk{s}", r), sp, causal=True).numpy()
    # the tiled all_to_all: heads split, sequence gathered, and its gradient
    x = _local(data, "a2a:x", r).requires_grad_(True)
    y = sp.tiled_all_to_all(x, split_dim=2, concat_dim=1)
    (y * _local(data, "a2a:w", r, dim=2)).sum().backward()
    out["a2a:y"], out["a2a:dx"] = y.detach().numpy(), x.grad.numpy()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the inputs, the 4 ranks' results)."""
    d = tmp_path_factory.mktemp("ring_attention")
    data = make_inputs()
    np.savez(d / "in.npz", **data)
    spawn(rank_main, N, f"file://{d}/rdv", backend="gloo", device="cpu",
          args=(str(d / "in.npz"), str(d)), threads=1, timeout_s=120)
    return data, [dict(np.load(d / f"rank{r}.npz", allow_pickle=True)) for r in range(N)]


def _global(ranks, key, dim=1):
    return np.concatenate([res[key] for res in ranks], axis=dim)


# ---- the JAX side -----------------------------------------------------------------


def full_attention(q, k, v, causal):
    """tests/test_ring_attention.py's single-device reference."""
    import jax
    import jax.numpy as jnp

    scale = q.shape[-1] ** -0.5
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        sg = q.shape[1]
        mask = jnp.arange(sg)[:, None] >= jnp.arange(sg)[None, :]
        s = jnp.where(mask[None, None], s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v)


def _jax_mapped(local, n_out=1):
    import jax
    from jax.sharding import PartitionSpec as P

    from paddlebox_tpu.parallel import make_mesh as jmesh
    from paddlebox_tpu.parallel.mesh import shard_map

    plan = jmesh(N, axis="sp")
    out_specs = P(None, "sp") if n_out == 1 else (P(None, "sp"),) * n_out
    mapped = jax.jit(shard_map(local, mesh=plan.mesh, in_specs=(P(None, "sp"),) * 3, out_specs=out_specs,
                               check_vma=False))
    return lambda *xs: mapped(*(jax.device_put(x, plan.sharded(None, plan.axis)) for x in xs))


def _jfn(impl):
    from paddlebox_tpu.parallel import ring_attention as jring
    from paddlebox_tpu.parallel import ulysses_attention as jul

    return jring if impl == "ring" else jul


def jax_forward(impl, causal, q, k, v):
    fn = _jfn(impl)
    return np.asarray(_jax_mapped(lambda a, b, c: fn(a, b, c, "sp", causal=causal))(q, k, v))


def jax_grads(impl, causal, q, k, v):
    """The JAX function's grads of the LOCAL sum on each device, as
    tests/test_ring_attention.py takes them."""
    import jax
    import jax.numpy as jnp

    fn = _jfn(impl)
    local = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c, "sp", causal=causal)), argnums=(0, 1, 2))
    return [np.asarray(g) for g in _jax_mapped(local, 3)(q, k, v)]


def full_grads(causal, q, k, v):
    import jax
    import jax.numpy as jnp

    g = jax.grad(lambda a, b, c: jnp.sum(full_attention(a, b, c, causal)), argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(x) for x in g]


def _qkv_np(data, tag):
    return [data[f"{tag}:{x}"] for x in "qkv"]


# ---- tests/test_ring_attention.py ---------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_matches_full_attention_and_jax(runs, impl, causal):
    data, ranks = runs
    q, k, v = _qkv_np(data, "fwd")
    got = _global(ranks, f"fwd:{impl}:{causal}")
    assert got.shape == q.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(full_attention(q, k, v, causal)), rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(got, jax_forward(impl, causal, q, k, v), rtol=FWD_RTOL, atol=FWD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", IMPLS)
def test_grads_match_full_attention_and_jax(runs, impl, causal):
    """d(sum(out))/d(q, k, v), each rank seeding its own block's sum,
    against full attention's grads and the JAX function's."""
    data, ranks = runs
    q, k, v = _qkv_np(data, "grad")
    want = full_grads(causal, q, k, v)
    jwant = jax_grads(impl, causal, q, k, v)
    for x, w, jw in zip("qkv", want, jwant):
        got = _global(ranks, f"grad:{impl}:{causal}:{x}")
        np.testing.assert_allclose(got, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"d{x} vs full")
        np.testing.assert_allclose(got, jw, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"d{x} vs the JAX {impl}")


def test_ulysses_head_divisibility():
    """6 heads over 4 ranks: both packages raise before any collective."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from paddlebox_tpu.parallel import make_mesh as jmesh
    from paddlebox_tpu.parallel.mesh import shard_map

    x = np.random.default_rng(2).normal(size=(B, S_LOC * N, 6, D)).astype(np.float32)
    plan = jmesh(N, axis="sp")
    with pytest.raises(ValueError, match="divisible"):
        shard_map(lambda a: _jfn("ulysses")(a, a, a, "sp"), mesh=plan.mesh, in_specs=(P(None, "sp"),),
                  out_specs=P(None, "sp"), check_vma=False)(jax.device_put(jnp.asarray(x), plan.sharded(None, "sp")))
    sp = MeshPlan(rank=1, world=N, device=torch.device("cpu"), backend="gloo", axis="sp")
    xl = torch.from_numpy(x[:, :S_LOC])
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(xl, xl, xl, sp)
    assert sp.calls["all_to_all"] == 0


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_inputs_accumulate_in_f32(runs, impl):
    data, ranks = runs
    for res in ranks:
        assert str(res[f"bf16:{impl}:dtype"]) == "torch.bfloat16"
    q, k, v = _qkv_np(data, "bf16")
    want = np.asarray(full_attention(q, k, v, True))
    err = np.abs(_global(ranks, f"bf16:{impl}") - want).max()
    assert err < BF16_MAX_ERR, err


# ---- beyond the JAX test ------------------------------------------------------------


@pytest.mark.parametrize("s", CHUNK_S)
def test_flash_local_chunks(runs, s):
    """Ulysses over a global S whose keys stream in 3 chunks (512, or the
    largest divisor of S under it) against the JAX function."""
    data, ranks = runs
    assert s // _chunk_size(s) == 3
    assert _chunk_size(s) == {1536: 512, 1200: 400}[s]
    q, k, v = _qkv_np(data, f"chunk{s}")
    got = _global(ranks, f"chunk{s}")
    np.testing.assert_allclose(got, jax_forward("ulysses", True, q, k, v), rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(got, np.asarray(full_attention(q, k, v, True)), rtol=FWD_RTOL, atol=FWD_ATOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_remat_saves_no_score_block(runs, impl):
    """With remat no [B, H, Sq, Sk] block is saved for the backward (the
    ring's [S_local, S_local], Ulysses' [S_global, chunk]); without it one
    is; the grads are bitwise alike."""
    _, ranks = runs
    rb, rs, rh, _ = REMAT
    sg = rs * N
    block = (rb, rh, rs, rs) if impl == "ring" else (rb, rh // N, sg, _chunk_size(sg))
    for res in ranks:
        with_remat = {tuple(s) for s in res[f"remat:{impl}:True:shapes"]}
        without = {tuple(s) for s in res[f"remat:{impl}:False:shapes"]}
        assert block not in with_remat, with_remat
        assert block in without, without
        for x in "qkv":
            assert res[f"remat:{impl}:True:{x}"].tobytes() == res[f"remat:{impl}:False:{x}"].tobytes()


@pytest.mark.parametrize("impl", IMPLS)
def test_collectives_of_a_forward_and_backward(runs, impl):
    _, ranks = runs
    want = np.array([WANT_CALLS[impl].get(k, 0) for k in CALLS])
    for res in ranks:
        for causal in (False, True):
            np.testing.assert_array_equal(res[f"calls:{impl}:{causal}"], want)


def test_tiled_all_to_all_matches_lax(runs):
    """Block order against ``lax.all_to_all(split_axis=2, concat_axis=1,
    tiled=True)`` on 4 devices, and the gradient against its transpose."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from paddlebox_tpu.parallel import make_mesh as jmesh
    from paddlebox_tpu.parallel.mesh import shard_map

    data, ranks = runs
    plan = jmesh(N, axis="sp")

    def a2a(x):
        return lax.all_to_all(x, "sp", 2, 1, tiled=True)

    def dx(x, w):
        return jax.grad(lambda a: jnp.sum(a2a(a) * w))(x)

    m = dict(mesh=plan.mesh, check_vma=False)
    y = shard_map(a2a, in_specs=(P(None, "sp"),), out_specs=P(None, None, "sp"), **m)(data["a2a:x"])
    g = shard_map(dx, in_specs=(P(None, "sp"), P(None, None, "sp")), out_specs=P(None, "sp"), **m)(
        data["a2a:x"], data["a2a:w"])
    assert ranks[0]["a2a:y"].shape == (A2A[0], A2A[1] * N, A2A[2] // N, A2A[3])
    np.testing.assert_array_equal(_global(ranks, "a2a:y", dim=2), np.asarray(y))
    np.testing.assert_array_equal(_global(ranks, "a2a:dx"), np.asarray(g))


@pytest.mark.parametrize("impl", IMPLS)
def test_tensors_off_the_plans_device_raise(impl):
    sp = MeshPlan(rank=0, world=N, device=torch.device("cpu"), backend="gloo", axis="sp")
    cpu = torch.zeros(B, S_LOC, H, D)
    meta = torch.zeros(B, S_LOC, H, D, device="meta")
    fn = _fns()[impl]
    with pytest.raises(ValueError, match="device"):
        fn(meta, cpu, cpu, sp)
    with pytest.raises(ValueError, match="device"):
        fn(cpu, cpu, meta, sp)
    with pytest.raises(ValueError, match="not an axis"):
        fn(cpu, cpu, cpu, sp, axis_name="dp")
    assert sp.calls == dict.fromkeys(sp.calls, 0)
