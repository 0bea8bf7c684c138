"""Global flag registry with environment passthrough.

Parity with the reference's gflags knobs (paddle/fluid/platform/flags.cc:477-607
defines the padbox_* family; global_value_getter_setter.cc exposes runtime
get/set). Flags are declared once with a type and default; the environment
variable ``PBOX_<UPPER_NAME>`` overrides the default at first read.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

_lock = threading.Lock()
_defs: Dict[str, tuple] = {}  # guarded-by: _lock  (name -> (type_fn, default, help, validator))
_values: Dict[str, Any] = {}  # guarded-by: _lock


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def define_flag(
    name: str,
    default: Any,
    help: str = "",
    validator: Optional[Callable[[Any], Any]] = None,
) -> None:
    """Declare a flag. ``validator`` (if given) runs on every set_flag and
    on the first env-sourced read, and must raise on an invalid value — a
    typo'd enum flag fails at the set site, not as a silent fallthrough
    wherever the value is eventually consumed."""
    type_fn: Callable
    if isinstance(default, bool):
        type_fn = _parse_bool
    elif isinstance(default, int):
        type_fn = int
    elif isinstance(default, float):
        type_fn = float
    else:
        type_fn = str
    with _lock:
        _defs[name] = (type_fn, default, help, validator)


def get_flag(name: str) -> Any:
    with _lock:
        if name in _values:
            return _values[name]
        if name not in _defs:
            raise KeyError(f"undefined flag: {name}")
        type_fn, default, _, validator = _defs[name]
        env = os.environ.get("PBOX_" + name.upper())
    # parse + validate OUTSIDE the lock: a validator may import its
    # consumer module, whose import-time flag reads would deadlock on the
    # non-reentrant registry lock
    val = type_fn(env) if env is not None else default
    if validator is not None and env is not None:
        validator(val)
    with _lock:
        return _values.setdefault(name, val)


def set_flag(name: str, value: Any) -> None:
    with _lock:
        if name not in _defs:
            raise KeyError(f"undefined flag: {name}")
        type_fn, _, _, validator = _defs[name]
    val = type_fn(value)
    if validator is not None:
        validator(val)
    with _lock:
        _values[name] = val


def all_flags() -> Dict[str, Any]:
    with _lock:
        names = list(_defs)
    return {n: get_flag(n) for n in names}


# --- data pipeline (reference: flags.cc padbox_* family) ---
# (knobs from the reference's padbox_* family are declared HERE only once a
# consumer reads them — pbox-lint REG003 flags defined-never-read knobs)
define_flag("enable_native_parser", True, "use the C++ slot parser fast path when eligible")
define_flag("sample_rate", 1.0, "line sampling rate on read (BufferedLineFileReader parity)")

# --- wire formats (ops/wire_quant.py reads these; the validators import it
# lazily, since it imports this module) ---


def _validate_wire_dtype(mode: str) -> None:
    from paddlebox_tpu_torch.ops import wire_quant

    wire_quant._check(mode)


def _validate_ici_wire_dtype(mode: str) -> None:
    from paddlebox_tpu_torch.ops import wire_quant

    wire_quant.check_ici(mode)


define_flag(
    "wire_dtype",
    "fp32",
    "value format on the host<->device boundary wire (carrier splice "
    "uploads, departing-slice fetch, flush, classic device writeback): "
    "fp32 | bf16 | int8 (int8 = per-row-scaled embed block + bf16 rest)",
    validator=_validate_wire_dtype,
)
define_flag(
    "ici_wire_dtype",
    "fp32",
    "value format of the sharded pull/push all_to_all payloads over ICI: "
    "fp32 | bf16 | int8 | adaptive (bf16/int8 keep the show/clk counter "
    "columns fp32; int8 carries one per-record max-abs scale; adaptive "
    "rides hot rows bf16 and the cold tail int8 — see ici_hot_frac / "
    "ici_hot_show / ici_wire_adaptive)",
    validator=_validate_ici_wire_dtype,
)
define_flag(
    "ici_wire_adaptive",
    True,
    "master ablation gate for ici_wire_dtype=adaptive: when False the "
    "adaptive mode degrades to fp32 and no hotness plumbing runs, so the "
    "wire (and every downstream bit) is identical to the pre-adaptive "
    "default — the bitwise off-ablation the convergence gates compare "
    "against",
)
define_flag(
    "ici_hot_frac",
    0.125,
    "static per-bucket hot-slot bound for the adaptive ICI wire: the "
    "first round(frac*K) slots of each per-shard request bucket ride "
    "bf16, the rest int8. Static so the all_to_all keeps one compiled "
    "shape; hot keys beyond the bound ride the int8 region (counted "
    "under wire.ici_hot_overflow_keys). 0 degrades to uniform int8, "
    "1 to uniform bf16 — both bitwise",
)
define_flag(
    "ici_hot_show",
    1.0,
    "decayed-show threshold above which a key counts as hot for the "
    "adaptive ICI wire (same scale as spill_pin_show: the tier's "
    "per-row decayed show column). Keys on the disk tier or not yet "
    "created read 0 = cold",
)
define_flag(
    "host_wire_codec",
    True,
    "host-plane wire codec (ops/host_codec.py): delta+varint key streams "
    "in the working-set exchange and chunked-zlib PBTX v3 frame payloads. "
    "False is the raw ablation — bitwise-identical results, more bytes "
    "(wire.host_raw_bytes_* vs wire.host_bytes_* measures the cut)",
)
define_flag(
    "host_compress_level",
    1,
    "zlib level for PBTX v3 frame payloads (1 = fastest: the codec runs "
    "on the sender's worker thread and must outrun the socket to win)",
)
define_flag(
    "host_compress_min_bytes",
    512,
    "frames smaller than this ship raw: below it the zlib+chunk-table "
    "overhead eats the win and the codec byte already marks them raw",
)

# --- sparse table ---
define_flag("sparse_table_shard_bits", 6, "log2 host shards in the tiered store")
define_flag("enable_pullpush_dedup_keys", True, "dedup keys across slots before pull (reference flags.cc:603)")

# --- batch / device ---
define_flag(
    "batch_bucket_rounding",
    2048,
    "flat key-count buckets rounded to multiples of this. Also the lever "
    "against compile-cache growth on long daily runs: pad shapes that "
    "repeat across passes HIT jax's compilation cache, drifting shapes "
    "miss it (~tens of host MB per distinct shape set; measured flat RSS "
    "at fixed shapes over a 14-pass soak)",
)

# --- host transport (parallel/transport.py) ---
define_flag(
    "transport_send_retries",
    3,
    "reconnect+resend attempts after a failed host-plane send before the "
    "error surfaces to the caller (each retry re-opens the peer connection "
    "and replays every un-acked frame)",
)
define_flag(
    "transport_backoff_s",
    0.1,
    "base of the exponential backoff between transport send retries "
    "(doubles per attempt, capped at 5s)",
)
define_flag(
    "transport_heartbeat_s",
    2.0,
    "interval of the per-peer heartbeat thread: each beat carries the "
    "delivered-frame ack that prunes the sender's resend buffer and feeds "
    "the failure detector; 0 disables the thread (no failure detection, "
    "resend buffers grow until reconnect)",
)
define_flag(
    "transport_peer_dead_s",
    15.0,
    "failure-detector horizon: a peer silent for half this is 'suspect', "
    "for all of it 'dead' — collectives stop waiting on dead peers and "
    "name them instead of running out the full timeout",
)

# --- serving plane (serve/) ---
define_flag(
    "serve_poll_interval_s",
    0.05,
    "follower watermark poll period: how often serve/follower.py re-reads "
    "latest.json looking for newly published deltas (the freshness half of "
    "the freshness/latency tradeoff — see docs/SERVING.md)",
)
define_flag(
    "serve_row_bucket",
    256,
    "request working-set capacity rounds to multiples of this before the "
    "compiled forward (serve-side analog of batch_bucket_rounding: bounds "
    "the distinct table shapes XLA compiles for, at the cost of padded "
    "gather rows)",
)
define_flag(
    "serve_key_bucket",
    256,
    "flat key-count padding bucket for score batches (the pack_batch "
    "bucket the scorer uses; smaller than the training default because "
    "serving batches are request-sized, not pass-sized)",
)
define_flag(
    "serve_batch_wait_ms",
    2.0,
    "max time the score server holds an under-full batch open waiting for "
    "more requests before scoring it (the latency half of the tradeoff: 0 "
    "scores every request alone, larger values amortize the compiled step)",
)
define_flag(
    "serve_require_manifest",
    True,
    "follower refuses snapshots without a manifest.json (legacy pre-"
    "manifest trees need False; the trainer-side resume path stays lenient "
    "either way)",
)
define_flag(
    "serve_request_timeout_ms",
    30000.0,
    "default per-request deadline for score requests, honored by the "
    "in-process ScoreServer.score wrapper (a wedged batcher surfaces as a "
    "typed ServeTimeoutError instead of blocking the caller forever) and "
    "used as the fleet client's default end-to-end budget",
)
define_flag(
    "serve_shed_queue_depth",
    256,
    "load-shedding threshold: a score submit arriving while the batcher "
    "queue already holds this many requests is refused with the typed "
    "ServeOverloadError (counted under serve.shed_requests) instead of "
    "growing an unbounded backlog; 0 disables shedding",
)
define_flag(
    "serve_health_beat_s",
    0.25,
    "cadence of each fleet follower's ctl:serve:health gossip beat to the "
    "front-end client (state, chain position, staleness, queue depth)",
)
define_flag(
    "serve_health_dead_s",
    2.0,
    "fleet-view freshness horizon: a follower whose last health beat is "
    "older than this is treated as dead by the load-balancing client and "
    "not queried (independent of the transport failure detector)",
)
define_flag(
    "serve_lag_deltas",
    2,
    "staleness gossip threshold: a follower whose applied delta_idx "
    "trails the fleet's freshest (same ownership epoch) by more than this "
    "many deltas is marked lagging and not queried until it catches up",
)
define_flag(
    "serve_hedge_ms",
    250.0,
    "hedged-dispatch trigger: when the primary follower has not answered "
    "within this budget (p99 about to blow), the fleet client re-sends "
    "the same request to a second healthy follower and takes the first "
    "answer; 0 disables hedging",
)
define_flag(
    "serve_client_retries",
    3,
    "bounded retry budget of the fleet client: attempts beyond the first "
    "pick a different follower with exponential backoff before the typed "
    "ServeRequestError surfaces to the caller",
)
define_flag(
    "serve_client_backoff_s",
    0.05,
    "base of the exponential backoff between fleet-client retry attempts "
    "(doubles per attempt)",
)
define_flag(
    "fleet_stage_dir",
    "",
    "host-local staging directory the fleet stager mirrors the published "
    "base+delta chain into — N followers on the host tail the stage, so "
    "the origin checkpoint root is fetched once per publish, not N times "
    "(empty: the FleetStage caller must pass an explicit directory)",
)


def _validate_device_scoring_tier(v: str) -> None:
    if v not in ("off", "on"):
        raise ValueError(
            f"device_scoring_tier must be 'off' or 'on', got {v!r}"
        )


define_flag(
    "device_scoring_tier",
    "off",
    "mesh-sharded device-resident hot-key scoring tier: 'on' builds a "
    "NamedSharding-placed copy of the hottest rows at every version "
    "commit (decayed-show >= device_tier_hot_show) and answers serve "
    "lookups from it through the sharded-pull path, falling back to the "
    "host TableVersion.lookup_rows only on tier misses; 'off' (the "
    "ablation) is bitwise-identical to the host-only serving path",
    validator=_validate_device_scoring_tier,
)
define_flag(
    "device_tier_hot_show",
    1.0,
    "decayed-show threshold a row must clear at commit time to enter the "
    "device scoring tier (same shows_peek signal the adaptive ICI wire "
    "uses; lower admits more of the tail, higher keeps HBM for the head)",
)
define_flag(
    "device_tier_capacity",
    65536,
    "max rows the device scoring tier holds per version; when more rows "
    "clear device_tier_hot_show, the hottest ones win (top-k by decayed "
    "show) and the rest serve from the host path",
)
define_flag(
    "serve_lb_least_loaded",
    True,
    "fleet-client load balancing: weigh the round-robin pick against the "
    "next candidate by gossiped queue depth (least-loaded-of-two, "
    "reroutes counted under serve.lb_rerouted); False is the pure "
    "round-robin ablation",
)

# --- streaming plane (train/stream.py) ---
def _validate_positive(v) -> None:
    if not v > 0:
        raise ValueError(f"flag value must be > 0, got {v!r}")


def _validate_stretch(v) -> None:
    if not v >= 1:
        raise ValueError(f"stream_backlog_max_stretch must be >= 1, got {v!r}")


define_flag(
    "stream_micro_pass_s",
    60.0,
    "time budget per streaming micro-pass: the StreamSupervisor collects "
    "tailed records for this long, then cuts them into one pass and "
    "publishes a delta through the normal watermark path (a minute-level "
    "cadence; the freshness SLO is roughly this plus train+publish+poll "
    "time)",
    validator=_validate_positive,
)
define_flag(
    "stream_poll_interval_s",
    1.0,
    "tail-follow poll period inside a micro-pass window: how often the "
    "DirectoryTailer re-scans the append-only dataset dir for grown or "
    "new files",
    validator=_validate_positive,
)
define_flag(
    "stream_compact_every",
    60,
    "micro-deltas between chain compactions: every N streamed publishes "
    "the manager folds base+delta-0001..N into one compact snapshot so a "
    "late follower's catch-up applies O(hours) artifacts, not O(minutes-"
    "since-base) (CheckpointManager.compact; <= 1 disables)",
)
define_flag(
    "stream_backlog_max_stretch",
    8.0,
    "graceful-degradation cap on the micro-pass cadence: when a cut takes "
    "longer than its budget (ingest backlog), the effective window doubles "
    "per overrun (counted under stream.backlog_stretches) up to budget * "
    "this factor, and shrinks back once cuts run under half budget",
    validator=_validate_stretch,
)

# --- metrics ---
define_flag("auc_num_buckets", 1_000_000, "AUC wuauc bucket table size (reference box_wrapper.h:61)")
define_flag("auc_runner_pool_size", 10_000, "AucRunner candidate reservoir capacity per pool")
