"""The port's host transport (``parallel/transport.py``) against the JAX
package's, on the wire.

- A JAX ``TcpTransport`` and a port ``TcpTransport`` as ranks 0 and 1 of
  one world, in threads of this process: ``send``/``recv``, ``alltoall``,
  ``allgather``, ``allreduce_max`` and ``barrier`` with the chunked-zlib
  codec on and off (the flags set in both registries), a trace-stamped
  frame, and a ``TcpShuffleRouter`` exchange of ``ColumnarRecords``
  between a port node and a JAX node. So the two PBTX v3 wires are one.
- The membership rounds (``agree_membership``, ``sync_map``) and the
  working-set exchange: the control tags a two-rank port cluster puts on
  the wire equal a two-rank JAX cluster's, and the rounds complete in a
  mixed world.
- The port's counterparts of ``tests/test_multihost.py``'s
  ``test_shuffle_round_no_double_delivery_after_reconnect`` and
  ``test_duplicate_replayed_frames_dropped_by_seq``, and of
  ``tests/test_fault_sites.py``'s connect and heartbeat flakes, under the
  port's own fault plans.

Every transport is closed in a ``finally`` and every thread joined with a
limit.
"""

from __future__ import annotations

import select
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.parallel import transport as jtransport
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.parallel import transport as ttransport

torch.set_num_threads(1)

FLAGS = ("host_wire_codec", "host_compress_min_bytes", "transport_heartbeat_s", "transport_backoff_s",
         "transport_send_retries", "shuffle_chunk_bytes", "transport_trace_frames")


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.fixture(autouse=True)
def restore_flags():
    prev = [(m, n, m.get_flag(n)) for m in (config, jconfig) for n in FLAGS]
    yield
    for m, n, v in prev:
        m.set_flag(n, v)


def set_both(**flags):
    for m in (config, jconfig):
        for k, v in flags.items():
            m.set_flag(k, v)


def world(kinds, timeout=20.0):
    """Transports of one world: ``kinds[r]`` is "jax" or "torch"."""
    eps = [f"127.0.0.1:{p}" for p in _free_ports(len(kinds))]
    mods = {"jax": jtransport, "torch": ttransport}
    return [mods[k].TcpTransport(r, eps, timeout=timeout) for r, k in enumerate(kinds)]


def run_ranks(fns, limit=60.0):
    """Run ``fns[r]()`` on a thread a rank; returns their results, raises
    the first failure."""
    out, errs = [None] * len(fns), []

    def body(r):
        try:
            out[r] = fns[r]()
        except BaseException as e:  # re-raised below
            errs.append(e)

    ths = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(len(fns))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(limit)
    assert not any(t.is_alive() for t in ths), "a rank did not finish"
    if errs:
        raise errs[0]
    return out


def close_all(ts):
    for t in ts:
        t.close()


# ---- a JAX rank and a port rank in one world ---------------------------------


@pytest.mark.parametrize("codec", [True, False])
def test_mixed_world_collectives(codec):
    set_both(host_wire_codec=codec, host_compress_min_bytes=64, transport_heartbeat_s=0.0)
    ts = world(["jax", "torch"])
    big = bytes(np.arange(4096, dtype=np.uint8) % 7)  # compressible, past the floor

    def rank(r):
        t = ts[r]

        def body():
            res = {}
            t.send(1 - r, "p2p", big + bytes([r]))
            res["p2p"] = t.recv("p2p", 1 - r)
            res["a2a"] = t.alltoall([f"{r}->{d}".encode() * 50 for d in range(2)], "a2a")
            res["ag"] = t.allgather(big[: 100 + r], "ag")
            res["max"] = t.allreduce_max(10 * (r + 1) - 25, "mx")
            t.barrier("end")
            return res

        return body

    try:
        got = run_ranks([rank(0), rank(1)])
    finally:
        close_all(ts)
    for r in range(2):
        assert got[r]["p2p"] == big + bytes([1 - r])
        assert got[r]["a2a"] == [f"{s}->{r}".encode() * 50 for s in range(2)]
        assert got[r]["ag"] == [big[:100], big[:101]]
        assert got[r]["max"] == -5


def test_mixed_world_counts_the_same_wire():
    """Both senders ship one compressed frame of one payload: the same
    frame bytes (header, tag, codec byte, CRC over the encoded body)."""
    from paddlebox_tpu.utils.monitor import STAT_GET as JSTAT
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    set_both(host_wire_codec=True, host_compress_min_bytes=64, transport_heartbeat_s=0.0)
    ts = world(["jax", "torch"])
    payload = b"paddlebox" * 1000
    try:
        j0, t0 = JSTAT("wire.host_bytes_sent"), STAT_GET("wire.host_bytes_sent")
        ts[0].send(1, "w", payload)
        ts[1].send(0, "w", payload)
        assert ts[1].recv("w", 0) == payload and ts[0].recv("w", 1) == payload
        assert JSTAT("wire.host_bytes_sent") - j0 == STAT_GET("wire.host_bytes_sent") - t0
        assert (ttransport._MAGIC, ttransport._VERSION) == (jtransport._MAGIC, jtransport._VERSION)
        for name in ("_HELLO", "_HELLO_REPLY", "_ACK", "_FRAME"):
            assert getattr(ttransport, name).format == getattr(jtransport, name).format
    finally:
        close_all(ts)


def test_mixed_world_trace_frames():
    """A trace-stamped frame (the 24-byte context extension, CRC-covered)
    from either package is delivered by the other and counted as a traced
    frame there."""
    from paddlebox_tpu.obs import trace_context as jtc
    from paddlebox_tpu.utils.monitor import STAT_GET as JSTAT
    from paddlebox_tpu_torch.obs import trace_context as ttc
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    set_both(transport_trace_frames=True, transport_heartbeat_s=0.0)
    ts = world(["jax", "torch"])
    try:
        j0, t0 = JSTAT("transport.trace_frames_recv"), STAT_GET("transport.trace_frames_recv")
        with ttc.trace_span("port-send"):
            ts[1].send(0, "tr", b"from-port")
        with jtc.trace_span("jax-send"):
            ts[0].send(1, "tr", b"from-jax")
        assert ts[0].recv("tr", 1) == b"from-port"
        assert ts[1].recv("tr", 0) == b"from-jax"
        assert JSTAT("transport.trace_frames_recv") == j0 + 1
        assert STAT_GET("transport.trace_frames_recv") == t0 + 1
    finally:
        close_all(ts)


def _stores(n_per, n_nodes=2):
    """(port stores, JAX stores): the same records, one store a node."""
    from paddlebox_tpu.data.record_store import ColumnarRecords as JCR
    from paddlebox_tpu.data.slot_record import SlotRecord as JSR
    from paddlebox_tpu.data.slot_schema import SlotInfo as JSI
    from paddlebox_tpu.data.slot_schema import SlotSchema as JSS
    from paddlebox_tpu_torch.data import SlotInfo, SlotSchema
    from paddlebox_tpu_torch.data.record_store import ColumnarRecords
    from paddlebox_tpu_torch.data.slot_record import SlotRecord

    def mk(cr, sr, si, ss, node):
        schema = ss([si("label", type="float", dense=True, dim=1), si("s0")], label_slot="label", parse_ins_id=True)
        recs = [sr(u64_values=np.array([i + 1], np.uint64), u64_offsets=np.array([0, 1], np.uint32),
                   f_values=np.array([float(i % 2)], np.float32), f_offsets=np.array([0, 1], np.uint32),
                   ins_id=f"n{node}-{i:03d}") for i in range(n_per + 10 * node)]
        return cr.from_records(recs, schema)

    return ([mk(ColumnarRecords, SlotRecord, SlotInfo, SlotSchema, n) for n in range(n_nodes)],
            [mk(JCR, JSR, JSI, JSS, n) for n in range(n_nodes)])


def test_mixed_world_shuffle_router():
    """A TcpShuffleRouter round between a JAX node and a port node, in
    sub-chunks: each collects exactly the records addressed to it."""
    set_both(shuffle_chunk_bytes=64, transport_heartbeat_s=0.0)
    ts = world(["jax", "torch"])
    port_stores, jax_stores = _stores(20)
    stores = [jax_stores[0], port_stores[1]]
    routers = [jtransport.TcpShuffleRouter(ts[0]), ttransport.TcpShuffleRouter(ts[1])]

    def node(r):
        def body():
            st = stores[r]
            half = len(st) // 2
            routers[r].exchange(r, [st.select(np.arange(0, half)), st.select(np.arange(half, len(st)))])
            return routers[r].collect(r)

        return body

    try:
        got = run_ranks([node(0), node(1)])
    finally:
        close_all(ts)
    for r in range(2):
        ids = sorted(c.ins_id(i) for c in got[r] for i in range(len(c)))
        want = sorted(stores[s].ins_id(i) for s in range(2) for i in range(len(stores[s]))
                      if (i < len(stores[s]) // 2) == (r == 0))
        assert ids == want


# ---- control tags -------------------------------------------------------------


def _tag_log(t):
    """Wrap a transport's send to log the tags it puts on the wire."""
    log, send = [], t.send

    def logged(dst, tag, payload):
        log.append(tag)
        return send(dst, tag, payload)

    t.send = logged
    return log


def _control_rounds(mem, dws, sparse, t, keys):
    """The membership rounds, then a working-set exchange, on one rank."""
    dead = mem.agree_membership(t, "s1")
    omap = mem.sync_map(t, "s1", dead, mem.OwnershipMap.even(4, t.n_ranks))
    lay_mod = sparse
    table = lay_mod.HostSparseTable(lay_mod.ValueLayout(embedx_dim=4), lay_mod.SparseOptimizerConfig(), n_shards=4,
                                    seed=0)
    ws = dws.DistributedWorkingSet(t, 4, pass_id=3, epoch=2, ownership=omap)
    ws.add_keys(keys)
    ws.finalize(table, round_to=8)
    t.barrier("done")
    return omap.to_json(), ws.sorted_keys, ws.row_of_sorted, ws.capacity


def _cluster_tags(kinds):
    import paddlebox_tpu.parallel.membership as jmem
    import paddlebox_tpu.table as jtab
    import paddlebox_tpu.table.dist_ws as jdws
    import paddlebox_tpu_torch.parallel.membership as tmem
    import paddlebox_tpu_torch.table as ttab
    import paddlebox_tpu_torch.table.dist_ws as tdws

    mods = {"jax": (jmem, jdws, jtab), "torch": (tmem, tdws, ttab)}
    ts = world(kinds)
    logs = [_tag_log(t) for t in ts]
    rng = np.random.default_rng(3)
    keys = [np.unique(rng.integers(1, 10_000, 300).astype(np.uint64)) for _ in kinds]
    try:
        out = run_ranks([
            (lambda r=r: _control_rounds(*mods[kinds[r]], ts[r], keys[r])) for r in range(len(kinds))
        ])
    finally:
        close_all(ts)
    return logs, out


def test_control_tags_equal_and_mixed_world_agrees():
    set_both(transport_heartbeat_s=0.0)
    jlogs, jout = _cluster_tags(["jax", "jax"])
    tlogs, tout = _cluster_tags(["torch", "torch"])
    assert jlogs == tlogs
    assert any(t.startswith("ctl:member:") for t in tlogs[0])
    assert any(t.startswith("ctl:mapsync:") for t in tlogs[0])
    assert {"ws-req:3@e2", "ws-cap:3@e2", "ws-rep:3@e2"} <= set(tlogs[0])
    mlogs, mout = _cluster_tags(["jax", "torch"])
    assert mlogs == tlogs
    for a, b, c in zip(jout, tout, mout):
        assert a[0] == b[0] == c[0]
        for i in (1, 2):
            np.testing.assert_array_equal(a[i], b[i])
            np.testing.assert_array_equal(a[i], c[i])
        assert a[3] == b[3] == c[3]


# ---- faults under the port's plans --------------------------------------------


def test_shuffle_round_no_double_delivery_after_reconnect():
    """A sender knocked over mid-round reconnects and replays its retained
    frames; per-destination sequence dedup drops the duplicates, so each
    sub-chunk is collected exactly once, and the next round is clean."""
    from paddlebox_tpu_torch.utils.faultinject import fail_nth, inject
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    set_both(transport_backoff_s=0.005, transport_send_retries=6, shuffle_chunk_bytes=64)
    ts = world(["torch", "torch"])
    routers = [ttransport.TcpShuffleRouter(t) for t in ts]
    try:
        for rnd in range(2):
            stores = _stores(20 + rnd)[0]
            resent_before = STAT_GET("transport.frames_resent")

            def node(r):
                def body():
                    st = stores[r]
                    half = len(st) // 2
                    routers[r].exchange(r, [st.select(np.arange(0, half)), st.select(np.arange(half, len(st)))])
                    return routers[r].collect(r)

                return body

            if rnd == 0:
                with inject(fail_nth("transport.recv_frame", 4, times=1),
                            fail_nth("transport.recv_frame", 9, times=1)):
                    out = run_ranks([node(0), node(1)])
                assert STAT_GET("transport.frames_resent") > resent_before, "no replay happened"
            else:
                out = run_ranks([node(0), node(1)])
            for r in range(2):
                got = sorted(c.ins_id(i) for c in out[r] for i in range(len(c)))
                want = sorted(stores[s].ins_id(i) for s in range(2) for i in range(len(stores[s]))
                              if (i < len(stores[s]) // 2) == (r == 0))
                assert got == want, f"round {rnd} rank {r}"
    finally:
        close_all(ts)


def test_duplicate_replayed_frames_dropped_by_seq():
    """A sender that replays already-delivered sequence numbers (its ack
    lost) has every one of them dropped by (src, seq); each tagged frame is
    delivered exactly once."""
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    T = ttransport
    eps = [f"127.0.0.1:{p}" for p in _free_ports(2)]
    t0 = T.TcpTransport(0, eps, timeout=10.0)

    def frame(seq, tag, payload):
        body = tag.encode() + payload
        return T._FRAME.pack(seq, T._KIND_DATA, T._CODEC_RAW, len(tag.encode()), len(payload), zlib.crc32(body)) + body

    def connect():
        s = socket.create_connection(("127.0.0.1", t0.port), timeout=5.0)
        s.sendall(T._HELLO.pack(T._MAGIC, T._VERSION, 1))
        buf = b""
        while len(buf) < T._HELLO_REPLY.size:
            buf += s.recv(T._HELLO_REPLY.size - len(buf))
        magic, version, delivered = T._HELLO_REPLY.unpack(buf)
        assert magic == T._MAGIC and version == T._VERSION
        return s, delivered

    try:
        s, acked = connect()
        assert acked == 0
        for seq, tag in ((1, "shuffle:0/n"), (2, "shuffle:0/0"), (3, "shuffle:0/1")):
            s.sendall(frame(seq, tag, f"payload-{seq}".encode()))
        assert t0.recv("shuffle:0/n", 1, timeout=5.0) == b"payload-1"
        s.close()
        dups_before = STAT_GET("transport.dup_frames_dropped")
        deadline = time.monotonic() + 5.0
        while True:
            s2, acked = connect()
            if acked == 3 or time.monotonic() > deadline:
                break
            s2.close()
            time.sleep(0.05)
        assert acked == 3, "the receiver must advertise the delivered count"
        for seq, tag in ((1, "shuffle:0/n"), (2, "shuffle:0/0"), (3, "shuffle:0/1"), (4, "shuffle:0/2")):
            s2.sendall(frame(seq, tag, f"payload-{seq}".encode()))
        assert t0.recv("shuffle:0/2", 1, timeout=5.0) == b"payload-4"
        assert STAT_GET("transport.dup_frames_dropped") >= dups_before + 3
        assert t0.recv("shuffle:0/0", 1, timeout=1.0) == b"payload-2"
        assert t0.recv("shuffle:0/1", 1, timeout=1.0) == b"payload-3"
        with pytest.raises(T.TransportTimeout):
            t0.recv("shuffle:0/n", 1, timeout=0.3)  # not delivered twice
        s2.close()
    finally:
        t0.close()


def test_connect_flake_absorbed_by_send_retry():
    from paddlebox_tpu_torch.utils.faultinject import fail_once, inject

    set_both(transport_backoff_s=0.005, transport_send_retries=4, transport_heartbeat_s=0.0)
    ts = world(["torch", "torch"], timeout=10.0)
    try:
        with inject(fail_once("transport.connect")) as plan:
            ts[0].send(1, "t", b"payload-after-connect-flake")
            assert ts[1].recv("t", 0) == b"payload-after-connect-flake"
            assert plan.failures("transport.connect") == 1
    finally:
        close_all(ts)


def test_heartbeat_flake_counted_and_survived():
    from paddlebox_tpu_torch.utils.faultinject import fail_once, inject
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    set_both(transport_backoff_s=0.005, transport_send_retries=4, transport_heartbeat_s=0.05)
    ts = world(["torch", "torch"], timeout=10.0)
    try:
        before = STAT_GET("transport.heartbeat_errors")
        with inject(fail_once("transport.heartbeat")) as plan:
            deadline = time.monotonic() + 10.0
            while plan.failures("transport.heartbeat") == 0:
                assert time.monotonic() < deadline, "heartbeat never fired"
                time.sleep(0.01)
        assert STAT_GET("transport.heartbeat_errors") == before + 1
        ts[0].send(1, "t", b"after-heartbeat-flake")
        assert ts[1].recv("t", 0) == b"after-heartbeat-flake"
    finally:
        close_all(ts)


def test_version_mismatch_is_typed():
    """A peer speaking another PBTX version is refused with the typed
    error naming both versions, never a hang."""
    set_both(transport_heartbeat_s=0.0)
    ts = world(["torch", "torch"], timeout=5.0)
    try:
        s = socket.create_connection(("127.0.0.1", ts[0].port), timeout=5.0)
        s.sendall(struct.pack("<4sHH", b"PBTX", 2, 1))
        reply = s.recv(ttransport._HELLO_REPLY.size)
        assert ttransport._HELLO_REPLY.unpack(reply)[1] == 3
        s.close()
        err = ttransport.VersionMismatchError(3, 2)
        assert isinstance(err, ttransport.ProtocolError) and "v2" in str(err)
    finally:
        close_all(ts)


def test_stalled_frame_body_drops_the_connection_and_the_resync_delivers():
    """A frame whose body stops arriving mid-way (a sender that keeps the
    connection but sends only beats after a partial frame) is dropped with
    its connection after the failure detector's horizon, though the
    trickle never idles a single read that long; the frame was never
    delivered, so a reconnect replays it whole and it lands once."""
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    T = ttransport
    prev = config.get_flag("transport_peer_dead_s")
    config.set_flag("transport_peer_dead_s", 0.6)
    set_both(transport_heartbeat_s=0.0)
    eps = [f"127.0.0.1:{p}" for p in _free_ports(2)]
    t0 = T.TcpTransport(0, eps, timeout=10.0)
    payload = b"x" * 4000
    body = b"t" + payload
    frame = T._FRAME.pack(1, T._KIND_DATA, T._CODEC_RAW, 1, len(payload), zlib.crc32(body)) + body
    beat = T._FRAME.pack(0, T._KIND_HEARTBEAT, T._CODEC_RAW, 0, T._ACK.size, zlib.crc32(T._ACK.pack(0)))
    beat += T._ACK.pack(0)

    def connect():
        s = socket.create_connection(("127.0.0.1", t0.port), timeout=5.0)
        s.sendall(T._HELLO.pack(T._MAGIC, T._VERSION, 1))
        buf = b""
        while len(buf) < T._HELLO_REPLY.size:
            buf += s.recv(T._HELLO_REPLY.size - len(buf))
        return s, T._HELLO_REPLY.unpack(buf)[2]

    try:
        stalls = STAT_GET("transport.frame_stalls")
        s, delivered = connect()
        assert delivered == 0
        s.sendall(frame[: T._FRAME.size + 100])
        t_start = time.monotonic()
        dropped = False
        while time.monotonic() - t_start < 5.0:
            # the receiver never writes after its handshake reply: readable
            # means it closed the connection
            if select.select([s], [], [], 0.05)[0]:
                dropped = True
                break
            s.sendall(beat)  # a trickle: every read returns before the horizon
        assert dropped, "the stalled connection was not dropped"
        assert 0.5 <= time.monotonic() - t_start < 5.0
        assert STAT_GET("transport.frame_stalls") == stalls + 1
        with pytest.raises((T.TransportTimeout, T.PeerDeadError)):
            t0.recv("t", 1, timeout=0.2)  # the stalled frame never landed (rank 1 is silent by now)
        s.close()
        s2, delivered = connect()
        assert delivered == 0  # so the resync replays seq 1
        s2.sendall(frame)
        assert t0.recv("t", 1, timeout=5.0) == payload
        s2.close()
    finally:
        config.set_flag("transport_peer_dead_s", prev)
        t0.close()
