"""The port's serving fleet (``serve/fleet.py``) against the JAX package's.

The five contracts of ``tests/test_serve_fleet.py`` on a port ``MiniFleet``
(a port producer publishing a base and deltas, a ``FleetStage`` mirroring
the chain, two ``FleetFollower``s each with its own ``Follower``,
``ScoreServer`` and ``Scorer`` on the CPU, and a ``FleetClient``), under
the port's fault plans:

- ``serve.request_recv``: a request lost after delivery is counted and the
  client's retry or hedge still returns the bitwise answer;
- ``serve.fleet_stage``: a torn stage fetch never writes the stage
  watermark, and the idempotent retry catches up;
- ``serve.drain``: a dropped drain command is counted and the client sends
  again until the follower's own gossip confirms; admit restores rotation;
- the typed overload refusal past ``serve_shed_queue_depth``;
- the hedge rescues a stalled follower within the deadline.

And the fleet's parity: the served preds are bitwise the trainer-direct
scoring (``Scorer.score_records`` over ``table_source``) at the base and
at a delta; a JAX ``FleetClient`` against port followers in one world
returns the same preds; a chain the JAX package wrote serves through the
port's fleet, bitwise the port's direct scoring of it (its params through
``models/convert.py``), and a chain the port wrote serves through the JAX
package's fleet, bitwise the JAX scorer's direct scoring of it.

The port keeps its own helpers (``tools/serve_soak.py`` builds a JAX
stack). Every transport is closed and every thread stopped in a teardown.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.data.parser import parse_line
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.parallel.transport import TcpTransport
from paddlebox_tpu_torch.serve import (
    FleetClient,
    FleetFollower,
    FleetStage,
    Follower,
    ScoreServer,
    Scorer,
    ServeOverloadError,
    table_source,
    version_source,
)
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CheckpointManager, CTRTrainer, TrainStepConfig, read_watermark
from paddlebox_tpu_torch.utils.faultinject import InjectedFault, fail_always, fail_once, inject
from paddlebox_tpu_torch.utils.fs import fs_open_write
from paddlebox_tpu_torch.utils.monitor import STAT_GET
from test_torch_coordinator import free_ports

torch.set_num_threads(1)

S, B, D = 4, 16, 4
HIDDEN = (8,)
DATE = "20260807"
LAYOUT = ValueLayout(embedx_dim=D)
OPT_KW = dict(embedx_threshold=0.0, show_clk_decay=0.97, shrink_threshold=0.0)
SCHEMA = SlotSchema([SlotInfo("label", type="float", dense=True, dim=1)] + [SlotInfo(f"s{i}") for i in range(S)],
                    label_slot="label")
FAST = {
    "transport_heartbeat_s": 0.05,
    "transport_backoff_s": 0.01,
    "serve_health_beat_s": 0.05,
    "serve_health_dead_s": 1.0,
    "serve_hedge_ms": 100.0,
    "serve_client_retries": 4,
    "serve_client_backoff_s": 0.02,
    "serve_request_timeout_ms": 15000.0,
}


@pytest.fixture(autouse=True)
def fast_fleet_flags():
    prev = [(m, n, m.get_flag(n)) for m in (config, jconfig) for n in FAST]
    for m in (config, jconfig):
        for n, v in FAST.items():
            m.set_flag(n, v)
    yield
    for m, n, v in prev:
        m.set_flag(n, v)


def model(seed=0):
    return DeepFM(S, LAYOUT.pull_width, D, hidden=HIDDEN, generator=torch.Generator().manual_seed(seed))


def step_cfg():
    return TrainStepConfig(num_slots=S, batch_size=B, layout=LAYOUT, sparse_opt=SparseOptimizerConfig(**OPT_KW),
                           auc_buckets=500)


def write_pass_file(rng, path, rows, lo):
    lines = []
    for _ in range(rows):
        keys = rng.integers(lo, lo + 200, S)
        lines.append(f"1 {float(keys[0] % 2)} " + " ".join(f"1 {k}" for k in keys))
    with fs_open_write(path) as f:
        f.write("\n".join(lines) + "\n")
    return lines


class Producer:
    """The port's trainer, table and checkpoint chain over ``root``."""

    def __init__(self, root, tmp):
        self.tmp = tmp
        self.rng = np.random.default_rng(0)
        self.table = HostSparseTable(LAYOUT, SparseOptimizerConfig(**OPT_KW), n_shards=4, seed=0)
        self.ds = BoxPSDataset(SCHEMA, self.table, batch_size=B, shuffle_mode="none")
        self.trainer = CTRTrainer(model(0), step_cfg(), dense_opt=Adam(1e-2), device="cpu")
        self.trainer.init_params()
        self.mgr = CheckpointManager(root)
        self.n_passes = 0
        self.lines = None

    def publish(self):
        """Train one pass and publish it (the base first, then deltas)."""
        path = os.path.join(self.tmp, f"pass-{self.n_passes}.txt")
        lines = write_pass_file(self.rng, path, 96, 1 + self.n_passes * 120)
        if self.lines is None:
            self.lines = lines
        self.ds.set_filelist([path])
        self.ds.load_into_memory()
        self.ds.begin_pass(round_to=8)
        self.trainer.train_pass(self.ds)
        self.ds.end_pass(self.trainer.trained_table())
        self.table.drain_pending()
        if self.n_passes == 0:
            self.mgr.save_base(DATE, self.table, self.trainer)
        else:
            self.mgr.save_delta(DATE, self.table, self.trainer)
        self.n_passes += 1


def make_follower(root):
    tr = CTRTrainer(model(1), step_cfg(), dense_opt=Adam(1e-2), device="cpu")
    fol = Follower(root, LAYOUT, SparseOptimizerConfig(**OPT_KW), n_host_shards=4, trainer=tr)
    return fol, Scorer(model(2), step_cfg(), device="cpu")


class MiniFleet:
    """One host's fleet: a producer, the shared stage, ``n`` followers
    (each its own Scorer, so one can be stalled) and a client, the client
    of ``client_kind`` ("torch" or "jax") at rank 0."""

    def __init__(self, tmp, n_followers=2, client_kind="torch"):
        self.tmp = str(tmp)
        self.root = os.path.join(self.tmp, "ckpt")
        self.stage_dir = os.path.join(self.tmp, "stage")
        self.prod = Producer(self.root, self.tmp)
        self.stage = FleetStage(self.root, self.stage_dir)
        self.stage_stop = threading.Event()
        self.stage_thread = threading.Thread(target=self.stage.run, args=(self.stage_stop, 0.02), daemon=True)
        self.stage_thread.start()
        eps = [f"127.0.0.1:{p}" for p in free_ports(n_followers + 1)]
        self.ranks = list(range(1, n_followers + 1))
        self.fleet = {}
        for r in self.ranks:
            tp = TcpTransport(r, eps, timeout=30.0)
            fol, scorer = make_follower(self.stage_dir)
            ff = FleetFollower(tp, 0, fol, scorer, SCHEMA, poll_interval_s=0.02, device="cpu")
            ff.start()
            self.fleet[r] = (tp, ff)
        if client_kind == "jax":
            from paddlebox_tpu.parallel.transport import TcpTransport as JTcpTransport
            from paddlebox_tpu.serve import FleetClient as JFleetClient

            self.client_tp = JTcpTransport(0, eps, timeout=30.0)
            self.client = JFleetClient(self.client_tp, self.ranks)
        else:
            self.client_tp = TcpTransport(0, eps, timeout=30.0)
            self.client = FleetClient(self.client_tp, self.ranks, SCHEMA)
        self.client.start()

    def publish(self):
        self.prod.publish()

    def probe_lines(self, n=16):
        return self.prod.lines[:n]

    def reference(self, n=16):
        """The trainer-direct scores of the probe (the parity truth)."""
        _tp, ff = self.fleet[self.ranks[0]]
        probe = [parse_line(ln, SCHEMA) for ln in self.probe_lines(n)]
        return ff.server.scorer.score_records(probe, SCHEMA, table_source(LAYOUT, self.prod.table),
                                              self.prod.trainer.params, self.prod.trainer.opt_state)

    def wait_delta(self, idx, timeout=20.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(ff.follower.version().delta_idx == idx for _, ff in self.fleet.values()):
                return
            time.sleep(0.02)
        raise AssertionError(f"followers never reached delta {idx}")

    def wait_queryable(self, want, timeout=20.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if set(self.client.view.queryable()) >= set(want):
                return
            time.sleep(0.02)
        raise AssertionError(f"fleet never queryable: want {sorted(want)}, view {self.client.view.snapshot()}")

    def close(self):
        self.client.stop()
        for tp, ff in self.fleet.values():
            ff.stop()
            tp.close()
        self.client_tp.close()
        self.stage_stop.set()
        self.stage_thread.join(timeout=10)


@pytest.fixture
def fleet(tmp_path):
    mf = MiniFleet(tmp_path)
    yield mf
    mf.close()


# ---- the recovery contracts ---------------------------------------------------


def test_request_recv_fault_absorbed_by_client_retry(fleet):
    fleet.publish()
    fleet.wait_queryable(fleet.ranks)
    ref = fleet.reference()
    errors0 = STAT_GET("serve.request_recv_errors")
    with inject(fail_once("serve.request_recv")) as plan:
        preds, meta = fleet.client.score_lines(fleet.probe_lines(8), timeout=15)
    assert plan.failures("serve.request_recv") == 1
    assert STAT_GET("serve.request_recv_errors") == errors0 + 1
    np.testing.assert_array_equal(preds, ref[:8])
    assert meta["delta_idx"] == 0


def test_fleet_stage_fault_never_surfaces_partial_version(tmp_path):
    root = os.path.join(str(tmp_path), "ckpt")
    stage_dir = os.path.join(str(tmp_path), "stage")
    prod = Producer(root, str(tmp_path))
    prod.publish()
    stage = FleetStage(root, stage_dir)
    with inject(fail_always("serve.fleet_stage", times=2)) as plan:
        for _ in range(2):
            with pytest.raises(InjectedFault):
                stage.stage_once()
            assert read_watermark(stage_dir) is None
        assert stage.stage_once() is True
    assert plan.failures("serve.fleet_stage") == 2
    assert read_watermark(stage_dir) == read_watermark(root)
    fol, scorer = make_follower(stage_dir)
    assert fol.poll_once() is True
    probe = [parse_line(ln, SCHEMA) for ln in prod.lines[:8]]
    v = fol.version()
    got = scorer.score_records(probe, SCHEMA, version_source(LAYOUT, v), v.params, v.opt_state)
    ref = scorer.score_records(probe, SCHEMA, table_source(LAYOUT, prod.table), prod.trainer.params,
                               prod.trainer.opt_state)
    np.testing.assert_array_equal(got, ref)


def test_drain_fault_client_resends_until_gossip_confirms(fleet):
    fleet.publish()
    fleet.wait_queryable(fleet.ranks)
    victim = fleet.ranks[0]
    errors0 = STAT_GET("serve.drain_errors")
    with inject(fail_once("serve.drain")) as plan:
        assert fleet.client.drain(victim, wait_s=10.0) is True
    assert plan.failures("serve.drain") == 1
    assert STAT_GET("serve.drain_errors") == errors0 + 1
    assert fleet.client.view.status(victim) in ("draining", "drained")
    _tp, ff = fleet.fleet[victim]
    assert ff.draining
    for _ in range(4):
        _preds, meta = fleet.client.score_lines(fleet.probe_lines(8), timeout=15)
        assert meta["src"] != victim
    assert fleet.client.drain(victim, wait_s=10.0) is True
    assert fleet.client.admit(victim, wait_s=10.0) is True
    assert not ff.draining
    fleet.wait_queryable(fleet.ranks)


def test_overload_shed_is_typed_and_counted(tmp_path):
    root = os.path.join(str(tmp_path), "ckpt")
    prod = Producer(root, str(tmp_path))
    prod.publish()
    fol, scorer = make_follower(root)
    fol.poll_once()
    probe = [parse_line(ln, SCHEMA) for ln in prod.lines[:8]]
    real = scorer.score_records

    def stalled(*a, **k):
        time.sleep(0.3)
        return real(*a, **k)

    scorer.score_records = stalled
    srv = ScoreServer(fol, scorer, SCHEMA, device="cpu")
    srv.start()
    prev = config.get_flag("serve_shed_queue_depth")
    config.set_flag("serve_shed_queue_depth", 1)
    shed0 = STAT_GET("serve.shed_requests")
    try:
        pendings = [srv.submit(probe)]
        time.sleep(0.05)
        pendings.append(srv.submit(probe))
        with pytest.raises(ServeOverloadError):
            for _ in range(8):
                pendings.append(srv.submit(probe))
        assert STAT_GET("serve.shed_requests") > shed0
        for p in pendings:
            assert p.result(10.0).shape == (8,)
    finally:
        config.set_flag("serve_shed_queue_depth", prev)
        scorer.score_records = real
        srv.stop()


def test_hedge_rescues_silent_follower(fleet):
    fleet.publish()
    fleet.wait_queryable(fleet.ranks)
    ref = fleet.reference()
    _tp, slow_ff = fleet.fleet[fleet.ranks[0]]
    real = slow_ff.server.scorer.score_records

    def stalled(*a, **k):
        time.sleep(1.5)  # well past serve_hedge_ms
        return real(*a, **k)

    slow_ff.server.scorer.score_records = stalled
    hedges0 = STAT_GET("serve.hedges")
    try:
        t0 = time.monotonic()
        for _ in range(2):  # round robin makes the slow rank primary within 2
            preds, _meta = fleet.client.score_lines(fleet.probe_lines(8), timeout=15)
            np.testing.assert_array_equal(preds, ref[:8])
        assert STAT_GET("serve.hedges") > hedges0
        assert time.monotonic() - t0 < 3.0
    finally:
        slow_ff.server.scorer.score_records = real


# ---- parity ---------------------------------------------------------------------


def test_served_preds_bitwise_trainer_direct_at_base_and_delta(fleet):
    """Every follower's answers are the trainer's own scoring, at the base
    and after a delta, and carry the chain position they were served at."""
    for idx in (0, 1):
        fleet.publish()
        fleet.wait_delta(idx)
        fleet.wait_queryable(fleet.ranks)
        ref = fleet.reference()
        srcs = set()
        for n in (1, 5, 16):
            preds, meta = fleet.client.score_lines(fleet.probe_lines(n), timeout=15)
            np.testing.assert_array_equal(preds, ref[:n])
            assert meta["delta_idx"] == idx
            srcs.add(meta["src"])
        assert srcs == set(fleet.ranks)


def test_jax_client_against_port_followers(tmp_path):
    """A JAX FleetClient and port followers share one world: the gossip,
    the request and response frames are one wire, and the preds are the
    port client's (the trainer-direct scoring)."""
    mf = MiniFleet(tmp_path, client_kind="jax")
    try:
        mf.publish()
        mf.wait_queryable(mf.ranks)
        ref = mf.reference()
        for _ in range(2):
            preds, meta = mf.client.score_lines(mf.probe_lines(8), timeout=15)
            np.testing.assert_array_equal(preds, ref[:8])
            assert meta["delta_idx"] == 0
        assert mf.client.drain(mf.ranks[1], wait_s=10.0) is True
        assert mf.client.admit(mf.ranks[1], wait_s=10.0) is True
    finally:
        mf.close()


def _serve_soak():
    """``tools/serve_soak.py``, the JAX package's serving stack helpers."""
    import sys

    tools = os.path.join(os.path.dirname(__file__), "..", "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import serve_soak

    return serve_soak


def _jax_producer(root, tmp):
    ss = _serve_soak()
    rng = np.random.default_rng(0)
    table, ds, cfg, trainer, mgr = ss.make_stack(root)
    path = os.path.join(tmp, "jax-pass-0.txt")
    lines = ss.write_pass_file(rng, path, 96, 1)
    ds.set_filelist([path])
    ds.load_into_memory()
    ds.begin_pass(round_to=8)
    trainer.train_pass(ds)
    ds.end_pass(trainer.trained_table_device())
    table.drain_pending()
    mgr.save_base(ss.DATE, table, trainer)
    return table, trainer, lines


def test_a_jax_chain_serves_through_the_port_fleet(tmp_path):
    """A chain the JAX package published, staged and served by the port's
    fleet: bitwise the port's scoring of the JAX table with the JAX params
    carried across by ``models/convert.py``."""
    from paddlebox_tpu_torch.models import params_from_jax

    root = os.path.join(str(tmp_path), "ckpt")
    stage_dir = os.path.join(str(tmp_path), "stage")
    jtable, jtrainer, lines = _jax_producer(root, str(tmp_path))
    stage = FleetStage(root, stage_dir)
    assert stage.stage_once() is True
    eps = [f"127.0.0.1:{p}" for p in free_ports(2)]
    tps = [TcpTransport(r, eps, timeout=30.0) for r in range(2)]
    fol, scorer = make_follower(stage_dir)
    ff = FleetFollower(tps[1], 0, fol, scorer, SCHEMA, poll_interval_s=0.02, device="cpu")
    client = FleetClient(tps[0], [1], SCHEMA)
    try:
        ff.start()
        client.start()
        deadline = time.monotonic() + 20
        while client.view.queryable() != [1] and time.monotonic() < deadline:
            time.sleep(0.02)
        preds, meta = client.score_lines(lines[:16], timeout=15)
    finally:
        client.stop()
        ff.stop()
        for t in tps:
            t.close()
    probe = [parse_line(ln, SCHEMA) for ln in lines[:16]]
    params = params_from_jax(jtrainer.params)
    ref = scorer.score_records(probe, SCHEMA, table_source(LAYOUT, jtable), params, None)
    np.testing.assert_array_equal(preds, ref)
    assert meta["delta_idx"] == 0


def test_a_port_chain_serves_through_the_jax_fleet(tmp_path):
    """The other way round: a chain the port published, staged and served
    by the JAX package's fleet, bitwise the JAX scorer's own scoring of the
    port's table with the port's params carried across."""
    import jax.numpy as jnp

    from paddlebox_tpu.parallel.transport import TcpTransport as JTcpTransport
    from paddlebox_tpu.serve import FleetClient as JFleetClient
    from paddlebox_tpu.serve import FleetFollower as JFleetFollower
    from paddlebox_tpu.serve import FleetStage as JFleetStage
    from paddlebox_tpu.serve import table_source as jtable_source
    from paddlebox_tpu_torch.models import params_to_jax

    ss = _serve_soak()
    root = os.path.join(str(tmp_path), "ckpt")
    stage_dir = os.path.join(str(tmp_path), "stage")
    prod = Producer(root, str(tmp_path))
    prod.publish()
    assert JFleetStage(root, stage_dir).stage_once() is True
    eps = [f"127.0.0.1:{p}" for p in free_ports(2)]
    tps = [JTcpTransport(r, eps, timeout=30.0) for r in range(2)]
    _, _, cfg, _, _ = ss.make_stack(os.path.join(str(tmp_path), "unused"))
    fol, scorer = ss.make_follower(stage_dir, cfg)
    ff = JFleetFollower(tps[1], 0, fol, scorer, ss.SCHEMA, poll_interval_s=0.02)
    client = JFleetClient(tps[0], [1])
    try:
        ff.start()
        client.start()
        deadline = time.monotonic() + 20
        while client.view.queryable() != [1] and time.monotonic() < deadline:
            time.sleep(0.02)
        preds, meta = client.score_lines(prod.lines[:16], timeout=15)
    finally:
        client.stop()
        ff.stop()
        for t in tps:
            t.close()
    from paddlebox_tpu.data.parser import parse_line as jparse_line

    probe = [jparse_line(ln, ss.SCHEMA) for ln in prod.lines[:16]]
    params = {k: jnp.asarray(v) if hasattr(v, "shape") else v for k, v in params_to_jax(prod.trainer.params).items()}
    ref = scorer.score_records(probe, ss.SCHEMA, jtable_source(ss.LAYOUT, prod.table), params, None)
    np.testing.assert_array_equal(preds, np.asarray(ref))
    assert meta["delta_idx"] == 0


@pytest.mark.parametrize("kind", ["torch", "jax"])
def test_fleet_wire_constants_are_the_jax_packages(kind):
    """The tags and the response header are one wire in both packages."""
    from paddlebox_tpu.serve import fleet as jfleet
    from paddlebox_tpu_torch.serve import fleet as tfleet

    mod = tfleet if kind == "torch" else jfleet
    assert (mod._REQ_TAG, mod._RESP_TAG, mod._HEALTH_TAG, mod._DRAIN_TAG) == (
        "serve:req", "serve:resp", "ctl:serve:health", "ctl:serve:drain")
    assert mod._RESP.format == "<QBiI" and mod._ST_NAMES == tfleet._ST_NAMES


def test_follower_defaults_to_the_card(tmp_path):
    """A fleet follower scores on ``cuda`` unless the caller asks for the
    CPU: with a CPU scorer and the default device it refuses."""
    fol, scorer = make_follower(str(tmp_path))
    with pytest.raises((ValueError, RuntimeError)):
        FleetFollower(None, 0, fol, scorer, SCHEMA)
