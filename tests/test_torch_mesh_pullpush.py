"""The sharded pull/push over the port's process-group mesh against the JAX
package's under ``shard_map``, at world 2 and 4, on the same numpy inputs.

The port's ranks are spawned once per world (gloo on the CPU, a
``file://`` rendezvous, one intra-op thread a rank); each runs every case
and writes its results to an ``.npz`` the tests read. The JAX side runs in
this process on ``make_mesh(n)`` over the suite's virtual CPU devices.

Bounds:

- ``sharded_pull``: bitwise in fp32, bf16, int8 and adaptive, plain and
  ``extended`` (a gather and the wire's casts, no arithmetic that could
  reorder);
- ``sharded_push``: the table within the port's push bounds (rtol 1e-6,
  atol 1e-7, ``tests/test_torch_ops.py``): the owner's merge is a segment
  sum whose order may differ from XLA's scatter-add; every row no rank
  touched is bitwise unchanged, and the padding row stays zero;
- ``_owner_merge_push`` in one process on the same flat records: the same
  bounds, untouched rows bitwise;
- the ``wire.a2a_*`` stats: exact.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import config as tconfig
from paddlebox_tpu_torch.fleet.launch import spawn
from paddlebox_tpu_torch.parallel.sharded_pullpush import _owner_merge_push, sharded_pull, sharded_push
from paddlebox_tpu_torch.table import SparseOptimizerConfig as TOpt
from paddlebox_tpu_torch.table import ValueLayout as TLayout
from paddlebox_tpu_torch.utils.monitor import STAT_GET

torch.set_num_threads(2)

MODES = ("fp32", "bf16", "int8", "adaptive")
CAP, K, SEED = 64, 16, 7
OPT_KW = dict(embed_lr=0.3, embedx_lr=0.2, embedx_threshold=2.0, initial_g2sum=3.0)
STATS = ("wire.a2a_payload_bytes", "wire.a2a_fp32_bytes", "wire.a2a_hot_slots", "wire.a2a_dtype_bits")


def _layout_kw(extended: bool):
    return dict(embedx_dim=8, expand_embed_dim=4 if extended else 0)


def make_case(n: int, extended: bool):
    """Table [n, CAP, W], requests [n, n, K] (distinct rows a bucket, the
    tail and slot K-1 the padding row), merged push records by bucket
    position (zero on pads)."""
    lay = TLayout(**_layout_kw(extended))
    rng = np.random.default_rng(SEED + n + 10 * extended)
    W = lay.width
    table = rng.normal(0, 0.3, (n, CAP, W)).astype(np.float32)
    table[:, :, lay.SHOW] = rng.integers(0, 5, (n, CAP)).astype(np.float32)
    table[:, :, lay.CLK] = rng.integers(0, 2, (n, CAP)).astype(np.float32)
    table[:, :, lay.embed_g2_col :] = rng.uniform(0, 1, (n, CAP, W - lay.embed_g2_col)).astype(np.float32)
    table[:, CAP - 1] = 0.0  # the padding row
    req = np.full((n, n, K), CAP - 1, dtype=np.int32)
    valid = np.zeros((n, n, K), dtype=bool)
    for d in range(n):
        for s in range(n):
            c = int(rng.integers(1, K - 1))
            req[d, s, :c] = rng.choice(CAP - 1 - 8, size=c, replace=False)  # rows >= CAP-9 untouched
            valid[d, s, :c] = True
    gw = lay.push_width + (lay.expand_dim if extended else 0)
    grads = rng.normal(0, 0.5, (n, n * K, gw)).astype(np.float32)
    show = rng.integers(1, 4, (n, n * K)).astype(np.float32)
    clk = np.minimum(rng.integers(0, 3, (n, n * K)), show).astype(np.float32)
    v = valid.reshape(n, n * K)
    grads *= v[..., None]
    show *= v
    clk *= v
    return table, req, grads, show, clk


def _cases():
    return [(m, ext) for m in MODES for ext in (False, True)]


def rank_main(plan, out_dir: str) -> None:
    """Every case on this rank; results to ``<out_dir>/rank<r>.npz``."""
    n, r = plan.world, plan.rank
    out = {}
    for mode, ext in _cases():
        table, req, grads, show, clk = make_case(n, ext)
        lay = TLayout(**_layout_kw(ext))
        opt = TOpt(**OPT_KW)
        tconfig.set_flag("ici_wire_dtype", mode)
        tag = f"{mode}_{int(ext)}"
        t = torch.from_numpy(table[r].copy())
        q = torch.from_numpy(req[r])
        out[f"pull_{tag}"] = sharded_pull(plan, t, q, lay, opt.embedx_threshold, 1.0, extended=ext).numpy()
        out[f"pullstats_{tag}"] = np.array([STAT_GET(k) for k in STATS], dtype=np.int64)
        sharded_push(
            plan, t, q, torch.from_numpy(grads[r]), torch.from_numpy(show[r]), torch.from_numpy(clk[r]), lay, opt
        )
        out[f"push_{tag}"] = t.numpy()
        out[f"pushstats_{tag}"] = np.array([STAT_GET(k) for k in STATS], dtype=np.int64)
    tconfig.set_flag("ici_wire_dtype", "fp32")
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def port_side(request, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"mesh_pullpush_{n}")
    spawn(rank_main, n, f"file://{d}/rdv", backend="gloo", device="cpu", args=(str(d),), threads=1, timeout_s=300)
    return n, [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]


def _jax_run(n: int, mode: str, ext: bool):
    """(pulled [n, n*K, w], pushed table [n, CAP, W], pull stats, push
    stats) from the JAX package under shard_map."""
    import jax
    from jax.sharding import PartitionSpec as P

    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.parallel import make_mesh
    from paddlebox_tpu.parallel.mesh import shard_map
    from paddlebox_tpu.parallel.sharded_pullpush import sharded_pull as jpull
    from paddlebox_tpu.parallel.sharded_pullpush import sharded_push as jpush
    from paddlebox_tpu.table import SparseOptimizerConfig, ValueLayout
    from paddlebox_tpu.utils.monitor import STAT_GET as JGET

    table, req, grads, show, clk = make_case(n, ext)
    lay = ValueLayout(**_layout_kw(ext))
    opt = SparseOptimizerConfig(**OPT_KW)
    plan = make_mesh(n)
    dp = P("dp")
    prev = jconfig.get_flag("ici_wire_dtype")
    jconfig.set_flag("ici_wire_dtype", mode)
    try:
        pull = jax.jit(shard_map(
            lambda t, q: jpull(t[0], q[0], lay, opt.embedx_threshold, 1.0, "dp", extended=ext)[None],
            plan.mesh, in_specs=(dp, dp), out_specs=dp, check_vma=False,
        ))
        pulled = np.asarray(pull(table, req))
        pstats = np.array([JGET(k) for k in STATS], dtype=np.int64)
        push = jax.jit(shard_map(
            lambda t, q, g, s, c: jpush(t[0], q[0], g[0], s[0], c[0], lay, opt, "dp")[None],
            plan.mesh, in_specs=(dp,) * 5, out_specs=dp, check_vma=False,
        ))
        pushed = np.asarray(push(table, req, grads, show, clk))
        qstats = np.array([JGET(k) for k in STATS], dtype=np.int64)
    finally:
        jconfig.set_flag("ici_wire_dtype", prev)
    return pulled, pushed, pstats, qstats


@pytest.mark.parametrize("mode,ext", _cases(), ids=[f"{m}-{'ext' if e else 'plain'}" for m, e in _cases()])
def test_sharded_pull_push_match_jax(port_side, mode, ext):
    n, ranks = port_side
    tag = f"{mode}_{int(ext)}"
    pulled, pushed, pstats, qstats = _jax_run(n, mode, ext)
    table0 = make_case(n, ext)[0]
    for r in range(n):
        np.testing.assert_array_equal(ranks[r][f"pull_{tag}"], pulled[r])
        np.testing.assert_array_equal(ranks[r][f"pullstats_{tag}"], pstats)
        np.testing.assert_array_equal(ranks[r][f"pushstats_{tag}"], qstats)
        got = ranks[r][f"push_{tag}"]
        np.testing.assert_allclose(got, pushed[r], rtol=1e-6, atol=1e-7)
        # rows no rank asked for (the last 8 before the padding row) and
        # the padding row keep their bytes
        np.testing.assert_array_equal(got[CAP - 9 :], table0[r][CAP - 9 :])
        assert not got[CAP - 1].any()
    if mode == "fp32" and not ext:
        assert pstats[0] == pstats[1]  # fp32: the payload is the fp32 bytes


def test_owner_merge_push_matches_jax():
    """The owner's merge alone, one process, on flat records with repeated
    rows in device-major order, as the all_to_all delivers them."""
    import jax.numpy as jnp

    from paddlebox_tpu.parallel.sharded_pullpush import _owner_merge_push as jmerge
    from paddlebox_tpu.table import SparseOptimizerConfig, ValueLayout

    rng = np.random.default_rng(3)
    lay_kw = _layout_kw(False)
    lay, tlay = ValueLayout(**lay_kw), TLayout(**lay_kw)
    M = 96
    table = rng.normal(0, 0.3, (CAP, lay.width)).astype(np.float32)
    table[:, lay.SHOW] = rng.integers(0, 5, CAP)
    table[CAP - 1] = 0.0
    ranks = rng.integers(0, CAP - 9, M).astype(np.int32)
    ranks[-10:] = CAP - 1  # pad requests
    recs = rng.normal(0, 0.5, (M, 2 + lay.push_width)).astype(np.float32)
    recs[:, 0] = rng.integers(1, 4, M)
    recs[:, 1] = rng.integers(0, 2, M)
    recs[-10:] = 0.0
    want = np.asarray(jmerge(jnp.asarray(table), jnp.asarray(ranks), jnp.asarray(recs), lay, SparseOptimizerConfig(**OPT_KW)))
    got = _owner_merge_push(
        torch.from_numpy(table.copy()), torch.from_numpy(ranks), torch.from_numpy(recs), tlay, TOpt(**OPT_KW)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[CAP - 9 :], table[CAP - 9 :])


def test_write_rows_ref_skips_out_of_range_ids():
    """The plain writeback route of the owner keeps the kernel's contract:
    an id outside [0, R) writes nothing (the owner's merge names its idle
    runs R), once ``drop_out_of_range`` has taken it out."""
    from paddlebox_tpu_torch.ops import cuda_kernels as ck

    table = torch.arange(40, dtype=torch.float32).reshape(8, 5)
    rows = torch.tensor([2, 8, -1, 5, 100], dtype=torch.int64)
    new = torch.full((5, 5), -1.0)
    with pytest.raises(IndexError):  # the plain writeback alone takes ids in range only
        ck.write_rows_ref(table.clone(), rows, new)
    got = ck.write_rows_ref(table.clone(), *ck.drop_out_of_range(table, rows, new))
    want = table.clone()
    want[[2, 5]] = -1.0
    assert torch.equal(got, want)
