"""Cross-process host transport: the open PaddleShuffler/MPICluster tier.

Port of the JAX package's ``parallel/transport.py``, byte-compatible with
it: the same PBTX v3 handshake and frames, the same codec byte, the same
trace extension, tags, flags, fault sites and counter names, so a port
rank and a JAX rank can be two ranks of one world.

The reference moves records between nodes through the closed
``boxps::PaddleShuffler`` (data_set.cc:1757-1926) and coordinates dense
sync/membership through the closed ``boxps::MPICluster`` (box_wrapper.h:
415-566). In the port the *device* plane is the ``torch.distributed``
group of ``parallel/mesh.py`` (NCCL or gloo collectives for the sparse
all_to_all and the dense all-reduce); what remains is the *host* plane —
record shuffle, pass working-set key exchange, batch-count lockstep —
which this module provides over plain TCP. The port runs one process a
card, so a host-plane node is one mesh rank: its transport rank is its
mesh rank, and the owner of mesh shard ``rank`` (several ranks of one
machine each run their own node over localhost):

- ``TcpTransport``: rank<->rank tagged message frames with persistent
  connections; primitives ``alltoall`` / ``allgather`` / ``allreduce_max``
  / ``barrier``. Peers are ``host:port`` strings, so the same code runs
  2 localhost subprocesses (the reference's own test pattern,
  test_dist_fleet_base.py:158-260) or N real hosts over the network.
- ``TcpShuffleRouter``: the LocalShuffleRouter exchange/collect contract
  across processes, chunks = serialized ColumnarRecords.

Tags scope rounds (e.g. ``shuffle:3``): a fast rank's frames for round
N+1 queue in the inbox without corrupting a slow rank's round N collect.

Fault tolerance (the MPICluster resilience the reference delegates to the
closed boxps tier, rebuilt in the open — see docs/ROBUSTNESS.md,
"Distributed plane"):

- Every connection opens with a versioned HELLO handshake; the accepting
  side replies ``_HELLO_REPLY`` (magic, its protocol version, the count of
  data frames it has already delivered from that peer), so a reconnecting
  sender resumes exactly where the receiver left off. Version capability
  is negotiated here: a mismatched peer gets the reply (carrying the
  listener's version) and a closed connection, and the sender raises the
  typed :class:`VersionMismatchError` naming both versions — never a hang,
  never downstream CRC noise. A pre-v3 peer that closes without any reply
  surfaces the same typed error with ``peer_version=None``.
- Every frame carries a per-destination sequence number, a codec byte
  (PBTX v3: 0 = raw, 1 = chunked zlib via ``ops/host_codec.py``), and a
  CRC32 over tag + *encoded* payload — corruption is caught before any
  inflate runs. The receiver drops duplicates (``seq <= delivered``) and
  kills the connection on checksum or decode failure — the sender's
  resync replays the lost tail, so a frame is delivered exactly once or
  the send fails loudly.
- Compression happens on the sender's calling thread *before* taking the
  per-destination send lock, so one peer's codec work overlaps another
  peer's socket write; ``wire.host_bytes_*`` (actual frame bytes) vs
  ``wire.host_raw_bytes_*`` (what v2 would have shipped) at this choke
  point are the measurement of what the codec saves.
- The send path keeps un-acked frames in a per-destination resend buffer
  and heals dropped connections with bounded exponential backoff
  (``transport_send_retries`` x ``transport_backoff_s``).
- A heartbeat thread (``transport_heartbeat_s``) beats every peer; beats
  carry the delivered-count ack that prunes the peer's resend buffer, and
  received traffic feeds a per-peer failure detector (silent for
  ``transport_peer_dead_s``/2 -> suspect, for the full horizon -> dead).
- Collectives are deadline-aware: a timeout names exactly which ranks and
  tags are missing (straggler report), and a peer the detector declares
  dead fails the collective immediately instead of running out the clock.
- Tags may carry an epoch suffix ``@e<N>`` (the DistributedWorkingSet
  rounds do). ``discard_epochs_below`` raises a floor below which frames
  are dropped — in the inbox now, and on delivery for late arrivals — so
  a coordinated pass retry can never consume a stale attempt's frames.
"""

from __future__ import annotations

import re
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Tuple

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.obs.flight_recorder import FLIGHT_RECORDER
from paddlebox_tpu_torch.obs.trace_context import EXT_LEN, current_trace, decode_ext
from paddlebox_tpu_torch.ops import host_codec
from paddlebox_tpu_torch.utils.faultinject import fire
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_OBSERVE
from paddlebox_tpu_torch.utils.trace import PROFILER, Profiler

_MAGIC = b"PBTX"
_VERSION = 3
# connection handshake: magic, protocol version, sender rank
_HELLO = struct.Struct("<4sHH")
# v3 handshake reply: magic, listener's protocol version, delivered
# data-frame count (the resync point). On version mismatch the listener
# still sends this (delivered=0) before closing, so the peer can name the
# incompatible version instead of guessing from a dropped connection.
_HELLO_REPLY = struct.Struct("<4sHQ")
# heartbeat ack payload: delivered data-frame count
_ACK = struct.Struct("<Q")
# frame header: seq, kind, codec, tag_len, payload_len,
# crc32(tag + encoded payload) — the CRC covers the bytes as shipped, so
# corruption is caught before any inflate
_FRAME = struct.Struct("<QBBHII")

_KIND_DATA = 0
_KIND_HEARTBEAT = 1
# high bit of ``kind``: the body is prefixed with a 24-byte trace-context
# extension (obs/trace_context.py EXT_STRUCT) BEFORE the tag. Covered by
# the frame CRC. Only ever set when flag transport_trace_frames is on —
# a pre-extension v3 reader would mis-slice the body and CRC-fail, so the
# sender opts in per deployment rather than per handshake.
_KIND_FLAG_TRACE = 0x80
_KIND_MASK = 0x7F

# frame payload codecs (PBTX v3)
_CODEC_RAW = 0
_CODEC_ZLIB = 1

_EPOCH_RE = re.compile(r"@e(\d+)$")

config.define_flag(
    "shuffle_chunk_bytes",
    64 << 20,
    "max serialized bytes per shuffle sub-chunk: bounds the sender's "
    "serialization RAM and keeps frames flowing so the receive timeout "
    "paces per-chunk gaps, not whole-pass serialization",
)


config.define_flag(
    "transport_trace_frames", False,
    "stamp outgoing PBTX data frames with the sender's active "
    "trace-context (trace_id, span_id) as a header extension, so "
    "obs_report --merge-traces can correlate spans across ranks; leave "
    "off when any peer predates the extension",
)


def _tag_epoch(tag: str) -> Optional[int]:
    m = _EPOCH_RE.search(tag)
    return int(m.group(1)) if m else None


def _recv_exact(sock: socket.socket, n: int, deadline: Optional[float] = None) -> bytes:
    """``n`` bytes off ``sock``; with a monotonic ``deadline`` the whole
    read raises ``socket.timeout`` past it, however the bytes trickle in
    (the socket is left in timeout mode)."""
    buf = bytearray()
    while len(buf) < n:
        if deadline is not None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise socket.timeout(f"{len(buf)} of {n} bytes by the deadline")
            sock.settimeout(left)
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


class TransportTimeout(TimeoutError):
    """A collective/recv deadline expired; ``missing`` names the
    still-absent (tag, src) pairs — the straggler report."""

    def __init__(self, msg: str, missing: List[Tuple[str, int]]):
        super().__init__(msg)
        self.missing = missing


class PeerDeadError(ConnectionError):
    """The failure detector declared a peer dead while a collective was
    waiting on it."""

    def __init__(self, msg: str, dead: List[int]):
        super().__init__(msg)
        self.dead = dead


class ProtocolError(ConnectionError):
    """Handshake magic/version mismatch — incompatible peer. Never
    retried: reconnecting cannot change the peer's protocol."""


class VersionMismatchError(ProtocolError):
    """HELLO version negotiation failed; names both protocol versions.

    ``peer_version`` is None when the peer closed without any version
    reply — the signature of a pre-v3 listener, which rejects unknown
    HELLO versions by silently dropping the connection."""

    def __init__(self, local: int, peer: Optional[int]):
        peer_s = (
            f"v{peer}"
            if peer is not None
            else "<= v2 (closed without a version reply)"
        )
        super().__init__(
            f"PBTX protocol version mismatch: local v{local}, peer {peer_s}"
        )
        self.local_version = local
        self.peer_version = peer


class _SendLink:
    """Sender-side state for one destination.

    Every field is guarded by the owning transport's per-destination send
    lock (``_send_locks[dst]``): ``sock`` (live connection or None),
    ``next_seq`` (last data seq assigned), ``acked`` (highest seq the peer
    confirmed via heartbeat ack or handshake), and ``retained`` — the
    in-order deque of (seq, frame_bytes) not yet acked, replayed after a
    reconnect so the receiver's stream resumes gaplessly."""

    __slots__ = ("sock", "next_seq", "acked", "retained", "was_connected")

    def __init__(self) -> None:
        self.sock: Optional[socket.socket] = None
        self.next_seq = 0
        self.acked = 0
        self.retained: deque = deque()
        self.was_connected = False


class TcpTransport:
    """Tagged rank-to-rank byte transport over TCP (fault-tolerant)."""

    def __init__(self, rank: int, endpoints: List[str], timeout: float = 120.0,
                 profiler: Optional[Profiler] = None):
        self.rank = rank
        self.n_ranks = len(endpoints)
        self.timeout = timeout
        # per-instance so an in-process multi-rank cluster (tests, chaos
        # soaks) can give each rank its own timeline; defaults to the
        # process-global profiler in real one-rank-per-process deployments
        self._profiler = profiler if profiler is not None else PROFILER
        self._endpoints = [self._parse(e) for e in endpoints]
        # (tag, src) -> FIFO of frames: a duplicate tag from one peer queues
        # behind the unconsumed first frame instead of overwriting it (a
        # dataset driven without set_date reuses pass-id-derived tags)
        self._cond = threading.Condition()
        self._inbox: Dict[Tuple[str, int], List[bytes]] = {}  # guarded-by: _cond
        self._delivered: Dict[int, int] = {}  # guarded-by: _cond
        self._last_seen: Dict[int, float] = {}  # guarded-by: _cond
        self._epoch_min = 0  # guarded-by: _cond
        # ranks the membership layer confirmed dead: collectives skip them
        # (send nothing, wait on nothing, b"" placeholder in results)
        self._dead: set = set()  # guarded-by: _cond
        self._send_locks: Dict[int, threading.Lock] = {
            r: threading.Lock() for r in range(self.n_ranks)
        }
        self._links: Dict[int, _SendLink] = {
            r: _SendLink() for r in range(self.n_ranks)
        }
        # accepted reader sockets: close() must tear these down too, or
        # their local port stays busy and a successor incarnation of this
        # rank cannot bind the same endpoint (elastic rejoin)
        self._conns: set = set()  # guarded-by: _cond
        self._closed = False
        # listener
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        host, port = self._endpoints[rank]
        try:
            self._server.bind((host, port))
        except OSError:
            self._close_sock(self._server)
            raise
        # rebind with the OS-assigned port if 0 was requested
        self._endpoints[rank] = self._server.getsockname()
        self._server.listen(self.n_ranks * 4)
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        # heartbeat: acks + failure detection; off when flag is 0 or the
        # "cluster" is a single rank
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        hb = float(config.get_flag("transport_heartbeat_s"))
        if hb > 0 and self.n_ranks > 1:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, args=(hb,), daemon=True
            )
            self._hb_thread.start()

    @staticmethod
    def _parse(ep: str) -> Tuple[str, int]:
        host, port = ep.rsplit(":", 1)
        return host, int(port)

    @property
    def port(self) -> int:
        return self._endpoints[self.rank][1]

    @staticmethod
    def _close_sock(sock: socket.socket) -> None:
        """Counted close — a failed close is rare but never silent."""
        try:
            sock.close()
        except OSError as e:
            STAT_ADD("transport.close_errors")
            PROFILER.instant("transport:close_error", {"error": repr(e)})

    # ---- receive side ----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._server.accept()
            except OSError:
                if not self._closed:
                    # the listening socket died UNDER a live transport —
                    # peers will see connect timeouts; make the root cause
                    # visible on this side
                    STAT_ADD("transport.accept_errors")
                return
            if self._closed:
                # raced close(): a handshake here would impersonate a dead
                # incarnation and silently eat the peer's retained tail
                # best-effort courtesy shutdown; the close below is the
                # real teardown and counts its own errors
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                # pbox-lint: disable=EXC007
                except OSError:
                    pass
                self._close_sock(conn)
                return
            with self._cond:
                self._conns.add(conn)
            threading.Thread(
                target=self._reader, args=(conn,), daemon=True
            ).start()

    def _reader(self, conn: socket.socket) -> None:
        src = -1
        try:
            # handshake under the transport timeout so a wedged peer can't
            # pin this reader forever; the frame loop then blocks freely
            conn.settimeout(self.timeout)
            magic, version, src = _HELLO.unpack(_recv_exact(conn, _HELLO.size))
            if magic != _MAGIC or version != _VERSION:
                STAT_ADD("transport.protocol_errors")
                self._profiler.instant(
                    "transport:protocol_error",
                    {"magic": repr(magic), "version": version,
                     "local_version": _VERSION},
                )
                if magic == _MAGIC:
                    # named rejection: the peer's connect parses our
                    # version out of the reply and raises the typed
                    # VersionMismatchError instead of diagnosing a hangup
                    try:
                        conn.sendall(_HELLO_REPLY.pack(_MAGIC, _VERSION, 0))
                    # best-effort courtesy reply; the mismatch itself was
                    # counted above as transport.protocol_errors
                    # pbox-lint: disable=EXC007
                    except (ConnectionError, OSError):
                        pass
                return
            incarnation_reset = False
            with self._cond:
                if src in self._dead and self._delivered.get(src, 0) > 0:
                    # a HELLO from a membership-dead rank is a NEW
                    # incarnation dialing in (elastic rejoin): its stream
                    # restarts at seq 1, so the old incarnation's delivered
                    # count must not eat the fresh frames as duplicates.
                    # Reset BEFORE the reply so the very first frame (the
                    # join announce) is deliverable even while the rank is
                    # still membership-dead.
                    self._delivered[src] = 0
                    incarnation_reset = True
                delivered = self._delivered.get(src, 0)
                self._last_seen[src] = time.monotonic()
            if incarnation_reset:
                STAT_ADD("transport.incarnation_resets")
            # resync point: the peer replays every frame after this count
            conn.sendall(_HELLO_REPLY.pack(_MAGIC, _VERSION, delivered))
            conn.settimeout(None)
            while True:
                fire("transport.recv_frame")
                seq, kind, codec, tag_len, n, crc = _FRAME.unpack(
                    _recv_exact(conn, _FRAME.size)
                )
                ext_len = EXT_LEN if kind & _KIND_FLAG_TRACE else 0
                kind &= _KIND_MASK
                # a body that stalls for the failure detector's horizon is
                # dropped with its connection: the sender's resync replays
                # the frame whole. Left blocking, a stalled body would eat
                # the peer's later beats as body bytes and starve this
                # side's detector of them for good
                stall_s = float(config.get_flag("transport_peer_dead_s"))
                try:
                    body = _recv_exact(
                        conn, ext_len + tag_len + n,
                        time.monotonic() + stall_s if stall_s > 0 else None,
                    )
                except socket.timeout:
                    STAT_ADD("transport.frame_stalls")
                    raise
                conn.settimeout(None)
                with self._cond:
                    self._last_seen[src] = time.monotonic()
                if zlib.crc32(body) != crc:
                    # corrupt frame: drop the connection BEFORE any
                    # inflate; the sender's resync replays everything
                    # un-delivered
                    STAT_ADD("transport.crc_errors")
                    self._profiler.instant(
                        "transport:crc_error", {"src": src, "seq": seq}
                    )
                    return
                tctx = decode_ext(body[:ext_len]) if ext_len else None
                tag = body[ext_len:ext_len + tag_len].decode()
                payload = body[ext_len + tag_len:]
                if kind == _KIND_DATA:
                    STAT_ADD(
                        "wire.host_bytes_recv",
                        _FRAME.size + ext_len + tag_len + n,
                    )
                if codec != _CODEC_RAW:
                    try:
                        fire("wire.host_decode")
                        if codec != _CODEC_ZLIB:
                            raise host_codec.HostCodecError(
                                f"unknown frame codec {codec}"
                            )
                        payload = host_codec.decompress_chunked(payload)
                    except (host_codec.HostCodecError, OSError) as e:
                        # decode failure (or injected wire.host_decode
                        # fault): kill the connection pre-delivery; the
                        # frame was never counted delivered, so the
                        # sender's resync replays it exactly once
                        STAT_ADD("transport.decode_errors")
                        self._profiler.instant(
                            "transport:decode_error",
                            {"src": src, "seq": seq, "error": repr(e)},
                        )
                        return
                if kind == _KIND_DATA:
                    STAT_ADD(
                        "wire.host_raw_bytes_recv",
                        _FRAME.size + tag_len + len(payload),
                    )
                if kind == _KIND_HEARTBEAT:
                    if len(payload) == _ACK.size:
                        self._prune_retained(src, _ACK.unpack(payload)[0])
                    continue
                dup = stale = False
                with self._cond:
                    if seq <= self._delivered.get(src, 0):
                        dup = True
                    else:
                        self._delivered[src] = seq
                        ep = _tag_epoch(tag)
                        if ep is not None and ep < self._epoch_min:
                            stale = True
                        else:
                            self._inbox.setdefault((tag, src), []).append(payload)
                            self._cond.notify_all()
                if dup:
                    STAT_ADD("transport.dup_frames_dropped")
                if stale:
                    STAT_ADD("transport.stale_frames_dropped")
                if tctx is not None and not dup and not stale:
                    # the cross-rank correlation point: this instant and
                    # the sender's transport:send share one trace_id
                    STAT_ADD("transport.trace_frames_recv")
                    args = tctx.as_args()
                    args.update({"src": src, "tag": tag, "seq": seq})
                    self._profiler.instant(
                        "transport:deliver", args, category="transport"
                    )
        except (ConnectionError, OSError):
            # a reader dying is how peer death first shows up on this
            # side; the heartbeat plane diagnoses it seconds later — count
            # the disconnect now so the two signals can be correlated
            STAT_ADD("transport.reader_disconnects")
            return
        finally:
            self._close_sock(conn)
            with self._cond:
                self._conns.discard(conn)

    def _pop_locked(self, tag: str, src: int) -> bytes:
        with self._cond:  # re-entrant: callers already hold it
            q = self._inbox[(tag, src)]
            payload = q.pop(0)
            if not q:
                del self._inbox[(tag, src)]
            return payload

    def _take_all(
        self, pairs: List[Tuple[str, int]], op: str, timeout: Optional[float]
    ) -> List[bytes]:
        """Wait for one frame per (tag, src); deadline-aware with a
        straggler report, and fail-fast on detector-dead peers. A dead
        peer also snapshots the flight recorder: the incident bundle
        (when flag obs_incident_dir is set) carries the last spans and
        stats leading up to the death."""
        try:
            return self._take_all_inner(pairs, op, timeout)
        except PeerDeadError as e:
            self._profiler.instant(
                "transport:peer_dead",
                {"op": op, "dead": list(e.dead), "rank": self.rank},
            )
            FLIGHT_RECORDER.dump("peer_dead", detail=str(e))
            raise

    def _take_all_inner(
        self, pairs: List[Tuple[str, int]], op: str, timeout: Optional[float]
    ) -> List[bytes]:
        budget = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + budget
        dead_s = float(config.get_flag("transport_peer_dead_s"))
        with self._cond:
            while True:
                missing = [p for p in pairs if p not in self._inbox]
                if not missing:
                    return [self._pop_locked(tag, src) for tag, src in pairs]
                now = time.monotonic()
                dead = sorted(
                    {
                        src
                        for _tag, src in missing
                        if src != self.rank
                        and (
                            src in self._dead  # membership-confirmed
                            or (
                                src in self._last_seen
                                and now - self._last_seen[src] >= dead_s
                            )
                        )
                    }
                )
                if dead:
                    raise PeerDeadError(
                        f"rank {self.rank}: {op} failed — "
                        f"rank(s) {dead} considered dead (no traffic for "
                        f">= {dead_s:.1f}s)",
                        dead,
                    )
                if now >= deadline:
                    report = ", ".join(
                        f"rank {src} ({self._peer_status_locked(src, now)}, "
                        f"tag {tag!r})"
                        for tag, src in sorted(missing, key=lambda p: p[1])
                    )
                    raise TransportTimeout(
                        f"rank {self.rank}: {op} timed out after "
                        f"{budget:.1f}s still waiting on: {report}",
                        missing,
                    )
                # short slices so dead-peer detection runs while waiting
                self._cond.wait(min(0.25, deadline - now))

    def recv(self, tag: str, src: int, timeout: Optional[float] = None) -> bytes:
        """Blocking receive of one frame (tag, src) — the public primitive
        streamed protocols (TcpShuffleRouter) build on."""
        return self._take_all([(tag, src)], f"recv(tag={tag!r})", timeout)[0]

    def recv_first(
        self, tag: str, srcs: List[int], timeout: Optional[float] = None
    ) -> Tuple[int, bytes]:
        """Client-mode receive: block until ANY of ``srcs`` has a queued
        frame under ``tag``; pop and return ``(src, payload)``.

        The serve front-end's primitive: a fleet client listening to N
        followers takes whichever response/health beat lands first (which
        is what makes hedged dispatch a pure race, no cancellation
        protocol). Unlike :meth:`_take_all`, ONE dead source is normal
        here — the call only fails fast with :class:`PeerDeadError` when
        EVERY source is membership- or detector-dead, because a fleet
        with any live follower must keep consuming from it."""
        srcs = [int(s) for s in srcs]
        if not srcs:
            raise ValueError("recv_first needs at least one source rank")
        budget = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + budget
        dead_s = float(config.get_flag("transport_peer_dead_s"))
        with self._cond:
            while True:
                for src in srcs:
                    if (tag, src) in self._inbox:
                        return src, self._pop_locked(tag, src)
                now = time.monotonic()
                dead = sorted(
                    src for src in set(srcs)
                    if src != self.rank
                    and (
                        src in self._dead
                        or (
                            src in self._last_seen
                            and now - self._last_seen[src] >= dead_s
                        )
                    )
                )
                if len(dead) == len(set(srcs)):
                    raise PeerDeadError(
                        f"rank {self.rank}: recv_first(tag={tag!r}) failed "
                        f"— every source rank {dead} considered dead",
                        dead,
                    )
                if now >= deadline:
                    raise TransportTimeout(
                        f"rank {self.rank}: recv_first(tag={tag!r}) timed "
                        f"out after {budget:.1f}s with no frame from any "
                        f"of ranks {sorted(set(srcs))}",
                        [(tag, s) for s in srcs],
                    )
                self._cond.wait(min(0.25, deadline - now))

    # ---- failure detector ------------------------------------------------

    def _peer_status_locked(self, src: int, now: float) -> str:
        if src == self.rank:
            return "alive"
        with self._cond:  # re-entrant: callers already hold it
            seen = self._last_seen.get(src)
        if seen is None:
            return "never seen"
        age = now - seen
        dead_s = float(config.get_flag("transport_peer_dead_s"))
        if age >= dead_s:
            return "dead"
        if age >= dead_s / 2:
            return "suspect"
        return "alive"

    def peer_status(self, src: int) -> str:
        """'alive' | 'suspect' | 'dead' | 'never seen' from received
        traffic (frames and heartbeats both count)."""
        with self._cond:
            return self._peer_status_locked(src, time.monotonic())

    def dead_peers(self) -> List[int]:
        with self._cond:
            now = time.monotonic()
            return [
                r
                for r in range(self.n_ranks)
                if r != self.rank
                and (
                    r in self._dead
                    or self._peer_status_locked(r, now) == "dead"
                )
            ]

    # ---- membership ------------------------------------------------------

    def mark_dead(self, ranks) -> None:
        """Confirm ranks dead at the membership layer: collectives stop
        sending to / waiting on them (their result slots become b""),
        direct sends fail fast, heartbeats stop. Reversed only by an
        explicit :meth:`mark_alive` when the membership layer admits a NEW
        incarnation at that slot (elastic join) — a recovered host rejoins
        with a fresh transport, not a resurrection of the old stream."""
        with self._cond:
            for r in ranks:
                r = int(r)
                if r != self.rank:
                    self._dead.add(r)
            # wake collectives blocked on a now-dead rank immediately
            self._cond.notify_all()

    def mark_alive(self, rank: int) -> None:
        """Readmit a previously mark_dead rank: the membership layer
        admitted a joiner at that slot (elastic grow).

        Deliberately touches ONLY membership + detector state. The
        outbound link keeps its seq space: a re-admitted peer that never
        actually died (an aborted join attempt, retried) still holds our
        delivered count, so resetting seqs would make every fresh frame
        look like a duplicate to it. A genuinely NEW incarnation (killed
        host rejoining with a fresh transport) is handled on the inbound
        side instead — its HELLO resets the delivered counter (see
        :meth:`_reader`), and its HELLO_REPLY resyncs our link the usual
        way. The detector gets a fresh grace window so the readmitted
        peer is not instantly re-declared dead by its old silence."""
        r = int(rank)
        if r == self.rank:
            return
        with self._cond:
            self._dead.discard(r)
            self._last_seen[r] = time.monotonic()
            self._cond.notify_all()

    def live_ranks(self) -> List[int]:
        """Ranks not membership-confirmed dead (always includes self).
        Detector state (suspect/dead by silence) does NOT remove a rank
        here — only an explicit mark_dead does, so collectives keep their
        fail-loudly semantics until membership actually changes."""
        with self._cond:
            return [r for r in range(self.n_ranks) if r not in self._dead]

    def is_marked_dead(self, rank: int) -> bool:
        with self._cond:
            return int(rank) in self._dead

    def pending_sources(self, tag: str) -> List[int]:
        """Non-consuming peek: source ranks with at least one queued frame
        under ``tag``. The elastic boundary scan uses this to notice
        waiting joiners without disturbing the inbox."""
        with self._cond:
            return sorted(
                {src for (t, src), q in self._inbox.items() if t == tag and q}
            )

    # ---- epoch discard ---------------------------------------------------

    def discard_epochs_below(self, epoch: int) -> int:
        """Raise the stale-epoch floor: queued frames whose tag ends with
        ``@e<k>``, k < epoch, are dropped now; late arrivals are dropped at
        delivery. Returns the number of frames purged from the inbox."""
        dropped = 0
        with self._cond:
            if epoch > self._epoch_min:
                self._epoch_min = epoch
            for key in list(self._inbox):
                ep = _tag_epoch(key[0])
                if ep is not None and ep < self._epoch_min:
                    dropped += len(self._inbox.pop(key))
        if dropped:
            STAT_ADD("transport.stale_frames_dropped", dropped)
        return dropped

    # ---- send side -------------------------------------------------------

    def _connect(self, dst: int) -> Tuple[socket.socket, int]:
        """Open + handshake one connection; returns (socket, acked_count)."""
        fire("transport.connect")
        s = socket.create_connection(self._endpoints[dst], timeout=self.timeout)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.sendall(_HELLO.pack(_MAGIC, _VERSION, self.rank))
            acked = self._read_hello_reply(s)
        except (ConnectionError, OSError):
            self._close_sock(s)
            raise
        return s, acked

    def _read_hello_reply(self, s: socket.socket) -> int:
        """Parse the listener's _HELLO_REPLY; typed failure on mismatch."""
        buf = bytearray()
        while len(buf) < _HELLO_REPLY.size:
            chunk = s.recv(_HELLO_REPLY.size - len(buf))
            if not chunk:
                if not buf:
                    # a pre-v3 listener rejects an unknown HELLO version
                    # by closing without any reply bytes
                    raise VersionMismatchError(_VERSION, None)
                raise ConnectionError("peer closed mid-handshake reply")
            buf.extend(chunk)
        magic, version, acked = _HELLO_REPLY.unpack(bytes(buf))
        if magic != _MAGIC:
            raise ProtocolError(
                f"handshake reply magic {magic!r} is not {_MAGIC!r} — "
                "peer is not a PBTX listener"
            )
        if version != _VERSION:
            raise VersionMismatchError(_VERSION, version)
        return acked

    def _reopen(self, dst: int, link: _SendLink) -> None:
        """(Re)connect and replay the un-acked tail. Caller holds the dst
        send lock."""
        sock, acked = self._connect(dst)
        if acked > link.acked:
            link.acked = acked
            while link.retained and link.retained[0][0] <= acked:
                link.retained.popleft()
        if link.was_connected:
            STAT_ADD("transport.reconnects")
        link.was_connected = True
        link.sock = sock
        for _seq, frame in link.retained:
            sock.sendall(frame)
            STAT_ADD("transport.frames_resent")

    def _prune_retained(self, dst: int, acked: int) -> None:
        with self._send_locks[dst]:
            link = self._links[dst]
            if acked > link.acked:
                link.acked = acked
                while link.retained and link.retained[0][0] <= acked:
                    link.retained.popleft()

    def _flush(self, dst: int, link: _SendLink, frame: Optional[bytes],
               tag: str, retries: Optional[int]) -> None:
        """Put ``frame`` (already retained) on the wire, reconnecting with
        bounded exponential backoff. Caller holds the dst send lock."""
        attempts = (
            int(config.get_flag("transport_send_retries"))
            if retries is None
            else retries
        )
        backoff = float(config.get_flag("transport_backoff_s"))
        for attempt in range(attempts + 1):
            try:
                fire("transport.send")
                if link.sock is None:
                    # the reopen replays the retained tail, frame included
                    self._reopen(dst, link)
                elif frame is not None:
                    link.sock.sendall(frame)
                return
            except ProtocolError:
                # incompatible peer: reconnecting cannot change its
                # protocol version, so fail loudly instead of burning the
                # retry budget (the typed error names both versions)
                STAT_ADD("transport.protocol_errors")
                raise
            except (ConnectionError, OSError) as e:
                if link.sock is not None:
                    self._close_sock(link.sock)
                    link.sock = None
                if attempt >= attempts:
                    if retries is None:
                        # data-path exhaustion; heartbeat callers count
                        # their own transport.heartbeat_errors instead
                        STAT_ADD("transport.send_errors")
                    self._profiler.instant(
                        "transport:send_error",
                        {
                            "dst": dst,
                            "tag": tag,
                            "attempts": attempt + 1,
                            "error": repr(e),
                        },
                    )
                    raise ConnectionError(
                        f"rank {self.rank}: send to rank {dst} "
                        f"(tag={tag!r}) failed after {attempt + 1} "
                        f"attempt(s): {e}"
                    ) from e
                STAT_ADD("transport.send_retries")
                time.sleep(min(backoff * (2 ** attempt), 5.0))

    def _encode_payload(self, payload: bytes) -> Tuple[int, bytes]:
        """Pick the wire codec for one data payload. Small payloads and
        payloads the codec fails to shrink ship raw — the codec byte makes
        every frame self-describing, so mixed traffic is fine."""
        if (
            len(payload) >= int(config.get_flag("host_compress_min_bytes"))
            and config.get_flag("host_wire_codec")
        ):
            comp = host_codec.compress_chunked(
                payload, int(config.get_flag("host_compress_level"))
            )
            if len(comp) < len(payload):
                return _CODEC_ZLIB, comp
        return _CODEC_RAW, payload

    def send(self, dst: int, tag: str, payload: bytes) -> None:
        tb = tag.encode()
        with self._cond:
            dst_dead = dst in self._dead
        if dst_dead:
            # fail fast instead of burning the retry budget against a rank
            # membership already buried
            raise PeerDeadError(
                f"rank {self.rank}: send to rank {dst} (tag={tag!r}) "
                "refused — rank is membership-confirmed dead",
                [dst],
            )
        if dst == self.rank:
            stale = False
            with self._cond:
                ep = _tag_epoch(tag)
                if ep is not None and ep < self._epoch_min:
                    stale = True
                else:
                    self._inbox.setdefault((tag, self.rank), []).append(payload)
                    self._cond.notify_all()
            if stale:
                STAT_ADD("transport.stale_frames_dropped")
            return
        # encode OUTSIDE the per-destination send lock, on the caller's
        # worker thread: one peer's compression overlaps another peer's
        # socket write instead of serializing behind it
        codec, wire_payload = self._encode_payload(payload)
        kind = _KIND_DATA
        ext = b""
        if config.get_flag("transport_trace_frames"):
            ctx = current_trace()
            if ctx is not None:
                # fresh span id per frame, same trace id: the receiver's
                # transport:deliver correlates back to this send
                wire_ctx = ctx.child()
                ext = wire_ctx.encode_ext()
                kind |= _KIND_FLAG_TRACE
                STAT_ADD("transport.trace_frames_sent")
                args = wire_ctx.as_args()
                args.update({"dst": dst, "tag": tag})
                self._profiler.instant(
                    "transport:send", args, category="transport"
                )
        body = ext + tb + wire_payload
        crc = zlib.crc32(body)
        with self._send_locks[dst]:
            link = self._links[dst]
            link.next_seq += 1
            frame = (
                _FRAME.pack(
                    link.next_seq, kind, codec, len(tb),
                    len(wire_payload), crc,
                )
                + body
            )
            link.retained.append((link.next_seq, frame))
            # counted per logical send (replays are not re-counted):
            # actual frame bytes vs what an uncompressed v2 frame of the
            # same header size would have shipped
            STAT_ADD("wire.host_bytes_sent", len(frame))
            STAT_ADD(
                "wire.host_raw_bytes_sent",
                _FRAME.size + len(tb) + len(payload),
            )
            STAT_OBSERVE("wire.frame_bytes", len(frame))
            # the frame is retained BEFORE the first wire attempt, so every
            # failure path (including a fault injected on the very first
            # send) replays it through the reconnect resync
            self._flush(dst, link, frame, tag, None)

    # ---- heartbeat -------------------------------------------------------

    def _heartbeat_loop(self, interval: float) -> None:
        while not self._hb_stop.wait(interval):
            if self._closed:
                return
            with self._cond:
                dead = set(self._dead)
            for dst in range(self.n_ranks):
                if dst == self.rank or dst in dead:
                    continue
                try:
                    fire("transport.heartbeat")
                    self._send_heartbeat(dst)
                except (ConnectionError, OSError):
                    # a down peer makes beats fail by design; the detector
                    # (driven by RECEIVED traffic) is what marks it dead
                    STAT_ADD("transport.heartbeat_errors")

    def _send_heartbeat(self, dst: int) -> None:
        with self._cond:
            delivered = self._delivered.get(dst, 0)
        payload = _ACK.pack(delivered)
        frame = (
            _FRAME.pack(
                0, _KIND_HEARTBEAT, _CODEC_RAW, 0, len(payload),
                zlib.crc32(payload),
            )
            + payload
        )
        with self._send_locks[dst]:
            link = self._links[dst]
            # single attempt, not retained: beats are periodic and
            # idempotent — but a beat that REOPENS a dropped connection
            # replays the retained data tail, which is exactly how a
            # receiver-side drop heals without waiting for the next send
            self._flush(dst, link, frame, "heartbeat", 0)

    # ---- collectives -----------------------------------------------------

    def alltoall(
        self, payloads: List[bytes], tag: str, timeout: Optional[float] = None
    ) -> List[bytes]:
        """payloads[d] goes to rank d; returns what every rank sent here.

        Membership-aware: ranks marked dead (``mark_dead``) are skipped on
        both sides — nothing is sent to them, nothing awaited from them,
        and their result slot is ``b""``. Callers that unpack typed
        payloads must skip non-live slots (see ``allreduce_max``)."""
        if len(payloads) != self.n_ranks:
            raise ValueError(f"need {self.n_ranks} payloads, got {len(payloads)}")
        live = self.live_ranks()
        for dst in live:
            try:
                self.send(dst, tag, payloads[dst])
            except PeerDeadError:
                raise
            except (ConnectionError, OSError):
                # the frame was retained before the first wire attempt, so
                # a transient drop heals via the heartbeat reconnect resync;
                # a real death fails the wait below with the detector's
                # typed PeerDeadError naming the rank — strictly more
                # information than a raw ConnectionError here
                STAT_ADD("transport.collective_send_deferred")
        got = self._take_all(
            [(tag, src) for src in live],
            f"alltoall(tag={tag!r})",
            timeout,
        )
        if len(live) == self.n_ranks:
            return got
        by_src = dict(zip(live, got))
        return [by_src.get(src, b"") for src in range(self.n_ranks)]

    def allgather(
        self, payload: bytes, tag: str, timeout: Optional[float] = None
    ) -> List[bytes]:
        return self.alltoall([payload] * self.n_ranks, tag, timeout=timeout)

    def allreduce_max(
        self, value: int, tag: str, timeout: Optional[float] = None
    ) -> int:
        vals = self.allgather(struct.pack("<q", int(value)), tag, timeout=timeout)
        # dead ranks contribute b"" placeholder slots, not votes
        return max(struct.unpack("<q", v)[0] for v in vals if len(v) == 8)

    def barrier(self, tag: str, timeout: Optional[float] = None) -> None:
        self.allgather(b"", "barrier:" + tag, timeout=timeout)

    def close(self) -> None:
        self._closed = True
        self._hb_stop.set()
        try:
            # shutdown BEFORE close: the accept thread blocked in accept()
            # holds the listening socket open past a bare close(), so the
            # dead incarnation would keep completing handshakes and eat
            # frames meant for its successor (elastic rejoin)
            self._server.shutdown(socket.SHUT_RDWR)
        # an already-dead listener (ENOTCONN and kin) is exactly the
        # state shutdown is driving toward; close() below counts errors
        # pbox-lint: disable=EXC007
        except OSError:
            pass
        try:
            self._server.close()
        except OSError as e:
            STAT_ADD("transport.close_errors")
            PROFILER.instant("transport:close_error", {"error": repr(e)})
        with self._cond:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            # shutdown BEFORE close: a reader blocked in recv() holds the
            # kernel socket open, so a bare close() would neither send FIN
            # to the peer nor wake the reader — the peer's link then looks
            # healthy forever and its frames vanish into this dead
            # incarnation instead of erroring over to the successor
            try:
                c.shutdown(socket.SHUT_RDWR)
            # a peer-reset conn is already down — the state shutdown is
            # driving toward; _close_sock counts real close errors
            # pbox-lint: disable=EXC007
            except OSError:
                pass
            self._close_sock(c)
        for r in range(self.n_ranks):
            with self._send_locks[r]:
                link = self._links[r]
                if link.sock is not None:
                    self._close_sock(link.sock)
                    link.sock = None
                link.retained.clear()


class TcpShuffleRouter:
    """LocalShuffleRouter's exchange/collect contract across processes.

    One router per (transport, dataset); ``exchange`` serializes each
    destination's ColumnarRecords chunk and all-to-alls them; ``collect``
    deserializes what arrived. The zero-length completion message of the
    reference's protocol (data_set.cc:1835-1866) is implicit: the chunk
    count header always arrives, even when zero chunks follow.

    Large passes stream in bounded sub-chunks (``shuffle_chunk_bytes``):
    the sender serializes at most one sub-chunk per destination at a time
    (peak extra RAM is the chunk size, not the whole part) and frames start
    arriving as soon as the first sub-chunk is cut, so the receive timeout
    paces per-chunk gaps instead of whole-pass serialization. The
    receiver's inbox is intentionally UNBOUNDED — it holds at most the
    in-flight pass, exactly like the reference's shuffle_channel_
    (data_set.cc:1870-1926); chunking bounds the sender side only.

    Round isolation under faults: the transport's per-destination frame
    sequencing means a round replayed by a reconnecting sender can never
    double-deliver a sub-chunk — duplicates are dropped by seq before the
    inbox, so ``collect`` sees each sub-chunk exactly once
    (tests/test_multihost.py::test_shuffle_round_no_double_delivery).
    """

    def __init__(self, transport: TcpTransport):
        self.transport = transport
        self.n_nodes = transport.n_ranks
        self._round = 0

    @staticmethod
    def _sub_ranges(chunk, chunk_bytes: int):
        """Split a ColumnarRecords part into ~<=chunk_bytes record ranges.

        Sized from EVERY serialized component (values, offsets, bases,
        search/cmatch/rank metadata, ins_id chars) — undercounting would
        let metadata-heavy stores blow past the sender-RAM bound."""
        import numpy as np

        n = len(chunk)
        total = (
            chunk.u64_values.nbytes
            + chunk.f_values.nbytes
            + chunk.u64_offsets.nbytes
            + chunk.f_offsets.nbytes
            + chunk.u64_base.nbytes
            + chunk.f_base.nbytes
            + chunk.search_ids.nbytes
            + chunk.cmatch.nbytes
            + chunk.rank.nbytes
            + (len(chunk.ins_id_chars) if chunk.ins_id_chars else 0)
            + (chunk.ins_id_off.nbytes if chunk.ins_id_off is not None else 0)
        )
        per = max(1, int(n * chunk_bytes / max(total, 1)))
        return [np.arange(i, min(i + per, n)) for i in range(0, n, per)]

    def exchange(self, from_node: int, parts: list) -> None:
        from paddlebox_tpu_torch.data.record_store import ColumnarRecords

        if from_node != self.transport.rank:
            raise ValueError("exchange must be called by the owning rank")
        chunk_bytes = int(config.get_flag("shuffle_chunk_bytes"))
        tag = f"shuffle:{self._round}"
        tp = self.transport
        # header first (sub-chunk count), then the streamed sub-chunks;
        # destinations interleave so no single slow peer starves the rest
        ranges = []
        for dst, chunk in enumerate(parts):
            if isinstance(chunk, ColumnarRecords):
                ranges.append(self._sub_ranges(chunk, chunk_bytes) if len(chunk) else [])
            elif len(chunk) == 0:
                ranges.append([])
            else:
                raise TypeError(
                    "TcpShuffleRouter moves ColumnarRecords chunks; got "
                    f"{type(chunk).__name__} (enable the native parser or "
                    "convert with ColumnarRecords.from_records)"
                )
        for dst, rs in enumerate(ranges):
            tp.send(dst, tag + "/n", struct.pack("<I", len(rs)))
        max_chunks = max((len(rs) for rs in ranges), default=0)
        for i in range(max_chunks):
            for dst, rs in enumerate(ranges):
                if i < len(rs):
                    tp.send(dst, f"{tag}/{i}", parts[dst].select(rs[i]).to_bytes())

    def collect(self, node: int) -> list:
        from paddlebox_tpu_torch.data.record_store import ColumnarRecords

        if node != self.transport.rank:
            raise ValueError("collect must be called by the owning rank")
        tag = f"shuffle:{self._round}"
        tp = self.transport
        out = []
        counts = [
            struct.unpack("<I", tp.recv(tag + "/n", src))[0]
            for src in range(self.n_nodes)
        ]
        for src, n in enumerate(counts):
            for i in range(n):
                out.append(ColumnarRecords.from_bytes(tp.recv(f"{tag}/{i}", src)))
        self._round += 1
        return out
