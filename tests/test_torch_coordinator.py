"""The verdict exchange (``EpochCoordinator``) and the stream's rounds of
the port's supervisor, against the JAX package's on the wire.

- ``EpochCoordinator``'s abort and lockstep retry (``tests/
  test_chaos_dist.py:434``), its ``fatal=True`` re-raise of a local timeout
  (``tests/test_elastic.py:985``) and the ``b""`` placeholders of ranks that
  membership confirmed dead, each run in both packages with the same
  results (ok, detail, epoch, the stale frame purged).
- ``stream_cut_round`` / ``stream_confirm_round`` fenced by the epoch
  (``tests/test_protocol_pin.py:150-195``): the tags a two-rank port
  cluster puts on the wire are the JAX cluster's.
- A mixed world, a JAX rank and a port rank over one PBTX v3 wire: the
  verdict and stream rounds agree, and a no from either side aborts both.

The transport knobs are the JAX tests' (``tests/test_elastic.py:82-97``),
set in both registries and restored after each test. Every transport is
closed in a ``finally`` and every rank thread joined with a limit.
"""

from __future__ import annotations

import socket
import threading

import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.parallel import transport as jtransport
from paddlebox_tpu.train import stream as jstream
from paddlebox_tpu.train import supervisor as jsup
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.parallel import transport as ttransport
from paddlebox_tpu_torch.train import stream as tstream
from paddlebox_tpu_torch.train import supervisor as tsup

torch.set_num_threads(1)

pytestmark = pytest.mark.chaos

FAST = {
    "transport_heartbeat_s": 0.05,
    "transport_backoff_s": 0.005,
    "transport_send_retries": 6,
    "transport_peer_dead_s": 60.0,
}
PKG = {
    "jax": (jtransport, jsup, jstream),
    "torch": (ttransport, tsup, tstream),
}


@pytest.fixture(autouse=True)
def fast_transport():
    prev = [(m, n, m.get_flag(n)) for m in (config, jconfig) for n in FAST]
    set_both(**FAST)
    yield
    for m, n, v in prev:
        m.set_flag(n, v)


def set_both(**flags):
    for m in (config, jconfig):
        for k, v in flags.items():
            m.set_flag(k, v)


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def world(kinds, timeout=30.0):
    """Transports of one world: ``kinds[r]`` is "jax" or "torch"."""
    eps = [f"127.0.0.1:{p}" for p in free_ports(len(kinds))]
    return [PKG[k][0].TcpTransport(r, eps, timeout=timeout) for r, k in enumerate(kinds)]


def run_ranks(fn, n, limit=60.0):
    """``fn(rank)`` on a thread a rank; the results in rank order, the
    first failure re-raised, and a rank still running after ``limit``
    seconds a failure of its own."""
    out, errs = [None] * n, []

    def body(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # re-raised below
            errs.append((r, e))

    ths = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(limit)
    assert not any(t.is_alive() for t in ths), "a rank did not finish within its limit"
    if errs:
        raise errs[0][1]
    return out


def close_all(ts):
    for t in ts:
        t.close()


# ---- EpochCoordinator ------------------------------------------------------


def _abort_then_retry(kind):
    """Rank 1 votes no at epoch 0; after advance() the epoch-1 round is
    clean and an epoch-0 frame left in flight is purged."""
    tmod, smod, _ = PKG[kind]
    tps = world([kind] * 3)
    try:
        coords = [smod.EpochCoordinator(t, timeout=10.0) for t in tps]
        tps[0].send(2, "ws-req:7@e0", b"stale")

        def round0(r):
            return coords[r].exchange_verdict("pass:1", ok=(r != 1), detail="" if r != 1 else "auc gate")

        r0 = run_ranks(round0, 3)
        for c in coords:
            c.advance()
        with pytest.raises(tmod.TransportTimeout):
            tps[2].recv("ws-req:7@e0", 0, timeout=0.3)
        r1 = run_ranks(lambda r: coords[r].exchange_verdict("pass:1", ok=True), 3)
        return r0, r1, [c.epoch for c in coords]
    finally:
        close_all(tps)


def test_epoch_coordinator_abort_and_lockstep_retry():
    got = {kind: _abort_then_retry(kind) for kind in PKG}
    r0, r1, epochs = got["torch"]
    for ok, detail in r0:
        assert not ok and "rank 1" in detail and "auc gate" in detail
    assert all(ok for ok, _ in r1) and epochs == [1, 1, 1]
    assert got["torch"] == got["jax"]


class _TimeoutTransport:
    rank = 0
    n_ranks = 2

    def allgather(self, payload, tag, timeout=None):
        raise TimeoutError("verdict round timed out")


@pytest.mark.parametrize("kind", ["torch", "jax"])
def test_fatal_raises_on_a_local_timeout(kind):
    """A commit-point verdict must not fold a local timeout into a quiet
    no: ``fatal=True`` re-raises, the default votes no."""
    coord = PKG[kind][1].EpochCoordinator(_TimeoutTransport())
    ok, detail = coord.exchange_verdict("migrate:x", True)
    assert not ok and "timed out" in detail
    with pytest.raises(TimeoutError):
        coord.exchange_verdict("migrate:x", True, fatal=True)


class _DeadSlotTransport:
    """Rank 2 of 3 is confirmed dead: its slot holds the ``b""`` a dead
    rank's allgather slot holds."""

    rank = 0
    n_ranks = 3

    def __init__(self, votes):
        self.votes = votes
        self.tags = []

    def allgather(self, payload, tag, timeout=None):
        self.tags.append(tag)
        return [payload] + self.votes

    def live_ranks(self):
        return [0, 1]


@pytest.mark.parametrize("peer_vote", [b"\x01", b"\x00bad gate"])
def test_dead_rank_placeholders_are_no_vote(peer_vote):
    """A dead rank's empty slot counts neither yes nor no; a live peer's
    no still aborts. Both packages give the same verdict and tag."""
    got = {}
    for kind in PKG:
        tp = _DeadSlotTransport([peer_vote, b""])
        coord = PKG[kind][1].EpochCoordinator(tp)
        coord.epoch = 3
        got[kind] = (coord.exchange_verdict("pass:2", True), tp.tags)
    assert got["torch"] == got["jax"]
    (ok, detail), tags = got["torch"]
    assert tags == ["ctl:verdict:pass:2@e3"]
    assert ok == (peer_vote == b"\x01")
    assert ("rank 1: bad gate" in detail) == (peer_vote != b"\x01")
    assert "rank 2" not in detail


@pytest.mark.parametrize("kind", ["torch", "jax"])
def test_peer_dead_raises_only_in_elastic_mode(kind):
    tmod, smod, _ = PKG[kind]

    class _DeadPeer:
        rank, n_ranks = 0, 2

        def allgather(self, payload, tag, timeout=None):
            raise tmod.PeerDeadError("peer 1 dead", [1])

    coord = smod.EpochCoordinator(_DeadPeer())
    ok, detail = coord.exchange_verdict("pass:1", True)
    assert not ok and "peer 1 dead" in detail
    coord.raise_peer_dead = True
    with pytest.raises(tmod.PeerDeadError):
        coord.exchange_verdict("pass:1", True)


# ---- the stream's rounds ---------------------------------------------------


def _tag_log(tps):
    seen, lock = set(), threading.Lock()
    for tp in tps:
        orig = tp.send

        def send(dst, tag, payload, _orig=orig):
            with lock:
                seen.add(tag)
            return _orig(dst, tag, payload)

        tp.send = send
    return seen


def _stream_rounds(kinds):
    tps = world(kinds)
    seen = _tag_log(tps)
    try:

        def run(r):
            _, smod, stmod = PKG[kinds[r]]
            coord = smod.EpochCoordinator(tps[r], timeout=10.0)
            out = [stmod.stream_cut_round(coord, 1), stmod.stream_confirm_round(coord, 1)]
            coord.advance()  # a revert: the next round rides the bumped suffix
            out.append(stmod.stream_cut_round(coord, 2))
            out.append(stmod.stream_cut_round(coord, 3, ok=(r != 1), detail="" if r != 1 else "spool crc"))
            tps[r].barrier("stream-pin-done")
            return out

        return run_ranks(run, len(kinds)), sorted(t for t in seen if t.startswith("ctl:"))
    finally:
        close_all(tps)


def test_stream_rounds_are_fenced_by_the_epoch():
    """The cut and confirm rounds ride ``ctl:verdict:stream-*`` scoped by
    the pass epoch: the tags of a port cluster are a JAX cluster's, and a
    peer's no aborts the cut on every rank."""
    port, port_tags = _stream_rounds(["torch", "torch"])
    ref, ref_tags = _stream_rounds(["jax", "jax"])
    assert port == ref
    assert port_tags == ref_tags
    for family in ("ctl:verdict:stream-cut:1@e0", "ctl:verdict:stream-confirm:1@e0", "ctl:verdict:stream-cut:2@e1"):
        assert family in port_tags
    for out in port:
        assert [ok for ok, _ in out] == [True, True, True, False]
        assert "rank 1: spool crc" in out[3][1]


# ---- a JAX rank and a port rank in one world --------------------------------


@pytest.mark.parametrize("kinds", [["jax", "torch"], ["torch", "jax"]])
@pytest.mark.parametrize("no_from", [None, 0, 1])
def test_mixed_world_verdict_rounds(kinds, no_from):
    """A JAX coordinator and a port coordinator share a world: the pass
    verdict and the stream rounds agree, and a no from either side aborts
    both, with the same detail on both sides."""
    tps = world(kinds)
    try:

        def run(r):
            _, smod, stmod = PKG[kinds[r]]
            coord = smod.EpochCoordinator(tps[r], timeout=10.0)
            ok_mine = no_from != r
            detail = "" if ok_mine else f"gate on {kinds[r]}"
            v = coord.exchange_verdict("pass:1", ok_mine, detail)
            coord.advance()
            cut = stmod.stream_cut_round(coord, 1, ok_mine, detail)
            conf = stmod.stream_confirm_round(coord, 1)
            return v, cut, conf, coord.epoch

        res = run_ranks(run, 2)
    finally:
        close_all(tps)
    assert res[0] == res[1]
    v, cut, conf, epoch = res[0]
    assert epoch == 1 and conf == (True, "")
    if no_from is None:
        assert v == cut == (True, "")
    else:
        for ok, detail in (v, cut):
            assert not ok and detail == f"rank {no_from}: gate on {kinds[no_from]}"
