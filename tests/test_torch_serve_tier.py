"""The device scoring tier against the JAX package's.

The JAX tier is one process over a mesh of the suite's 8 virtual CPU
devices; the port's holds shard ``s`` on ``device[s]``, here eight CPU
shards (``device=["cpu"] * 8``) or one. Checks:

- ``route_serve_requests`` bitwise the JAX function's at 1, 2 and 8
  requesters, empty requests included;
- an 8-shard tier built by ``ScoringTable.commit(hotness=)`` has the JAX
  tier's ``pad_rank``, ``mem_used_mb``, row count, per-shard keys, and its
  lookups the JAX tier's rows, hit masks and hit/miss tallies, bitwise;
- ``lookup_rows_tiered`` is bitwise ``lookup_rows`` on 1 and 8 shards,
  with tier misses and key misses counted apart;
- a ``device_tier_capacity`` below the hot rows keeps the JAX package's
  exact key set (the hottest, ties broken by key order);
- a kill at ``serve.tier_build`` leaves the served version as it was and
  a retry builds the same tier;
- through a ``Follower``: flag ``off`` builds no tier, flag ``on`` with
  eight CPU shards builds the JAX follower's tier, its preds bitwise the
  host-only preds and its health snapshot counting the tier;
- flag ``on`` with no device on a host without a GPU raises (never a
  quiet host-only version).
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.data.device_pack import route_serve_requests as jroute
from paddlebox_tpu.serve.scoring_table import ScoringTable as JScoringTable
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.device_pack import route_serve_requests
from paddlebox_tpu_torch.serve import Follower, ScoringTable, version_source
from paddlebox_tpu_torch.table import SparseOptimizerConfig
from paddlebox_tpu_torch.utils import faultinject as fault
from paddlebox_tpu_torch.utils.monitor import STAT_GET
from test_torch_follower import LAYOUT, OPT_KW, SCHEMA, Stack

torch.set_num_threads(2)

W, N_KEYS, DATE = 8, 3000, "20261017"
EIGHT = ["cpu"] * 8


@pytest.fixture
def flags():
    """Set a flag in both registries for a test, restored after."""
    before = []

    def set_both(**kw):
        for k, v in kw.items():
            before.append((k, config.get_flag(k), jconfig.get_flag(k)))
            config.set_flag(k, v)
            jconfig.set_flag(k, v)

    yield set_both
    for k, p, j in reversed(before):
        config.set_flag(k, p)
        jconfig.set_flag(k, j)


def _version_inputs(seed=0, n=N_KEYS):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 40, 2 * n).astype(np.uint64))
    keys = np.sort(keys[rng.permutation(len(keys))[:n]])
    rows = rng.normal(size=(n, W)).astype(np.float32)
    # decayed shows: a quarter hot, ties at 2.0 and 3.0
    hot = rng.choice(np.array([0.0, 0.5, 2.0, 3.0, 7.5], np.float32), n, p=[0.5, 0.25, 0.1, 0.1, 0.05])
    return keys, rows, hot


def _queries(keys, seed=1, n=700):
    rng = np.random.default_rng(seed)
    miss = rng.integers(1 << 41, 1 << 42, n // 5).astype(np.uint64)  # keys no version holds
    return rng.permutation(np.concatenate([rng.choice(keys, n - len(miss)), miss]))


def _commit(table, keys, rows, hot, **kw):
    return table.commit(keys, rows, date=DATE, delta_idx=0, decay_epoch=0, hotness=hot, **kw)


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_route_serve_requests_matches_jax(n_devices):
    rng = np.random.default_rng(n_devices)
    for m in (0, 1, 37, 500):
        owner = rng.integers(0, n_devices, m)
        local = rng.integers(0, 300, m)
        got, jgot = route_serve_requests(owner, local, n_devices, 16, 511), jroute(owner, local, n_devices, 16, 511)
        assert got[2] == jgot[2]
        for a, b in zip(got[:2], jgot[:2]):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_eight_shard_tier_matches_jax(flags):
    flags(device_tier_hot_show=1.0, device_tier_capacity=65536)
    keys, rows, hot = _version_inputs()
    v = _commit(ScoringTable(W, device=EIGHT), keys, rows, hot)
    jv = _commit(JScoringTable(W), keys, rows, hot)
    t, jt = v.device_tier, jv.device_tier
    assert jt.n_shards == t.n_shards == 8
    assert t.pad_rank == jt.pad_rank and t.n_rows == jt.n_rows == int((hot >= 1.0).sum())
    assert t.mem_used_mb() == jt.mem_used_mb()
    for a, b in zip(t._shard_keys, jt._shard_keys):
        np.testing.assert_array_equal(a, b)
    for seed in (1, 2):
        q = _queries(keys, seed)
        (rows_t, hit), (jrows, jhit) = t.lookup_rows(q), jt.lookup_rows(q)
        np.testing.assert_array_equal(hit, jhit)
        assert rows_t.tobytes() == jrows.tobytes()
    assert (t.hits, t.misses) == (jt.hits, jt.misses) and t.hits > 0 and t.misses > 0


@pytest.mark.parametrize("device", ["cpu", EIGHT], ids=["one_shard", "eight_shards"])
def test_tiered_lookup_is_bitwise_host_lookup(flags, device):
    flags(device_tier_hot_show=1.0, device_tier_capacity=65536)
    keys, rows, hot = _version_inputs(seed=2)
    v = _commit(ScoringTable(W, device=device), keys, rows, hot)
    q = _queries(keys, seed=3)
    want, n_key_miss = v.lookup_rows(q)
    before = {k: STAT_GET(k) or 0 for k in ("serve.device_tier_hits", "serve.device_tier_misses")}
    got, n_tier_miss, n_key_miss2 = v.lookup_rows_tiered(q)
    assert got.tobytes() == want.tobytes()
    n_hit = int(np.isin(q, keys[hot >= 1.0]).sum())
    assert n_tier_miss == len(q) - n_hit and n_key_miss2 == n_key_miss == int((~np.isin(q, keys)).sum())
    assert STAT_GET("serve.device_tier_hits") - before["serve.device_tier_hits"] == n_hit
    assert STAT_GET("serve.device_tier_misses") - before["serve.device_tier_misses"] == n_tier_miss


def test_capacity_keeps_the_jax_key_set(flags):
    flags(device_tier_hot_show=1.0, device_tier_capacity=101)  # cuts through the 2.0 and 3.0 ties
    keys, rows, hot = _version_inputs(seed=4)
    t = _commit(ScoringTable(W, device=EIGHT), keys, rows, hot).device_tier
    jt = _commit(JScoringTable(W), keys, rows, hot).device_tier
    assert t.n_rows == jt.n_rows == 101
    got, want = np.sort(np.concatenate(t._shard_keys)), np.sort(np.concatenate(jt._shard_keys))
    np.testing.assert_array_equal(got, want)
    order = np.argsort(-hot[np.isin(keys, got)], kind="stable")
    assert hot[np.isin(keys, got)][order][-1] >= hot[~np.isin(keys, got)].max()


def test_kill_at_tier_build_keeps_the_old_version(flags):
    flags(device_tier_hot_show=1.0, device_tier_capacity=65536)
    keys, rows, hot = _version_inputs(seed=5)
    tab = ScoringTable(W, device=EIGHT)
    v0 = _commit(tab, keys, rows, hot)
    rows0 = v0.rows.copy()
    with fault.inject(fault.fail_once("serve.tier_build")):
        with pytest.raises(fault.InjectedFault):
            tab.commit(keys, rows + 1.0, date=DATE, delta_idx=1, decay_epoch=0, hotness=hot)
    assert tab.version() is v0 and tab.committed_indices() == [0] and v0.rows.tobytes() == rows0.tobytes()
    v1 = tab.commit(keys, rows + 1.0, date=DATE, delta_idx=1, decay_epoch=0, hotness=hot)
    q = _queries(keys, seed=6)
    assert v1.lookup_rows_tiered(q)[0].tobytes() == v1.lookup_rows(q)[0].tobytes()
    assert v1.device_tier.n_rows == v0.device_tier.n_rows


def test_tier_without_a_device_raises_on_a_host_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys, rows, hot = _version_inputs(seed=7, n=50)
    tab = ScoringTable(W)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        _commit(tab, keys, rows, hot)
    assert tab.version().delta_idx == -1
    assert _commit(tab, keys, rows, None).device_tier is None  # no hotness: host-only, no device asked


def test_follower_tier_matches_jax_and_serves_host_preds(tmp_path, flags):
    from paddlebox_tpu_torch.train import Adam, CTRTrainer
    from test_torch_follower import _port_model

    st = Stack(tmp_path)
    st.publish_base()
    flags(device_tier_hot_show=0.5, device_scoring_tier="off")

    def follower(on):
        flags(device_scoring_tier="on" if on else "off")
        tr = CTRTrainer(_port_model(1), st.cfg, dense_opt=Adam(1e-2), device="cpu")
        fol = Follower(st.root, LAYOUT, SparseOptimizerConfig(**OPT_KW), n_host_shards=4, trainer=tr,
                       device=EIGHT)
        assert fol.poll_once()
        return fol

    off, on = follower(False), follower(True)
    jfol = st.new_jfollower()
    assert jfol.poll_once()  # the flag is on in both registries
    v_off, v_on = off.version(), on.version()
    assert v_off.device_tier is None and off.health_snapshot()["tier_rows"] == 0
    t, jt = v_on.device_tier, jfol.version().device_tier
    assert t.n_rows == jt.n_rows > 0 and t.pad_rank == jt.pad_rank
    for a, b in zip(t._shard_keys, jt._shard_keys):
        np.testing.assert_array_equal(a, b)
    preds = {}
    for name, fol in (("off", off), ("on", on)):
        v = fol.version()
        preds[name] = st.scorer.score_records(st.probe, SCHEMA, version_source(LAYOUT, v), v.params)
    assert preds["on"].tobytes() == preds["off"].tobytes()
    snap = on.health_snapshot()
    assert snap["tier_rows"] == t.n_rows and snap["tier_hits"] == t.hits > 0
    assert snap["tier_misses"] == t.misses
