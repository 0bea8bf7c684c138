"""Pass-loop trainer: the BoxPSTrainer/BoxPSWorker analog on one device.

Port of the JAX package's ``train/trainer.py``, single device. One
``CTRTrainer`` owns the training step and walks a ``BoxPSDataset`` pass by
pass:

    trainer = CTRTrainer(model, cfg, device="cuda")
    dataset.load_into_memory(); dataset.begin_pass()
    trainer.prepare_pass(dataset, n_batches)      # optional: freeze pads
    metrics = trainer.train_pass(dataset, n_batches)
    dataset.end_pass(trainer.trained_table())         # classic boundary
    # or dataset.end_pass(trainer.trained_table_device()): carried

``train_pass`` takes one of these feeds, as the JAX package does, and
names it in ``last_feed``:

1. the resident feed (``train/resident_step.py``), when the pass is
   store-backed (native parser) and ``enable_resident_feed`` is on: the
   pass's row stream and index partition are uploaded once, and each
   dispatch runs ``resident_scan_batches`` steps on batches built on the
   device ("resident"; a model that takes ``rank_offset`` stays off it);
2. the packer feed, store-backed with the resident feed off:
   ``BatchPacker`` packs each batch natively in prefetch threads, which
   also pin it; the dispatch thread copies it to the device
   asynchronously from the pinned memory, so the copy waits for nothing
   ("packer");
3. the slow feed, for a pass held as SlotRecords (Python parser):
   ``build_batch`` + ``pack_batch`` + a copy per batch on the dispatch
   thread ("slow").

The join phase (``dataset.pv_merged`` and ``current_phase`` 1) has its own
three: the pass's ``PvPlan`` resident on the device, a dispatch a [K]
slice of batch positions ("resident_pv"); the packer over the plan's
record indices, with its rank matrices and ghost weights
("pv_packer"); and, for a pass held as SlotRecords, ``pv_batches``
packed in one prefetch worker ("pv_records"). ``set_test_mode(True)``
makes every feed run the eval step (forward and AUC; table, params and
optimizer state as they were); the eval supersteps are cached beside the
training ones. With a ``metric_registry`` each batch's outputs, with its
``cmatch``, ``rank`` and ``ins_weight``, feed it under the dataset's
``current_phase``; on the resident feeds those inputs are device slices
of columns uploaded once a pass, so the registry adds no host sync.

At most ``max_inflight_steps`` dispatches are in flight (one superstep
ahead on the resident feeds); the wait is on a CUDA event recorded after
the oldest one, so it never waits for the work queued behind it. Dense
params and the optimizer state persist across passes on the device; the
sparse working-set table is rebuilt per pass, as a copy of the dataset's
pass table (a host array, or the spliced device tensor of a carried
boundary): the step writes the table in place, and a table handed to
``end_pass`` through :meth:`~CTRTrainer.trained_table_device` stays with
its carrier untouched.

``save_dense`` / ``load_dense`` write and read the JAX package's dense
file (the leaves of its ``(params, optax.adam state)`` tree, in the order
``models/convert.py`` spells out, for every zoo model), so a checkpoint
crosses packages either way. ``load_dense`` (and a ``PassGuard`` revert)
drop every device-side cache, so the next pass trains from the loaded
state.

The JAX trainer's single-device options, with its names and meanings:

- ``dense_slot`` / ``dense_dim`` / ``pack_bucket``: a float slot's first
  ``dense_dim`` values become the model's ``dense`` input on every feed
  (``pack_batch``, ``BatchPacker``, ``ResidentPass``), the pad bucket
  ``pack_bucket``;
- ``async_dense`` (with ``dense_sync_mode="async"``): a host
  ``AsyncDenseTable`` owns the dense optimizer. The resident feeds are not
  taken; before every batch the step gets a copy of the table's params,
  after it the trainer pushes the step's gradients, and at the pass's end
  ``params`` are the table's (``opt_state`` untouched);
- ``dump_pool`` and ``dump_*``: each kept batch's ``dump_fields_list``
  per instance (``ins_id`` from the store, else ``b{step}:{j}``) and, with
  ``dump_params_at_end``, the params at the pass's end under the JAX
  package's leaf names and layouts. A dump reads each batch back to the
  host, as the JAX trainer does;
- ``box``: a ``BoxWrapper`` whose ``test_mode`` also makes a pass an eval
  pass.

On a single-host mesh (``plan=``, a ``parallel.MeshPlan``; one process a
card, every rank running the same script over the same files, so its
dataset with ``n_mesh_shards=world`` is a replica) each rank trains its
shard of the pass table with the mesh step (``train/sharded_step.py``):

    plan = make_mesh("nccl")                  # under torchrun --nproc-per-node N
    cfg = TrainStepConfig(..., batch_size=B // plan.world)   # per rank
    dataset = BoxPSDataset(schema, table, B, n_mesh_shards=plan.world)
    trainer = CTRTrainer(model, cfg, plan=plan)
    ... the same pass loop; end_pass(trainer.trained_table())

The feeds are chosen as on one device and named alike: "resident"
(each rank builds its route buckets on its card:
``make_resident_superstep`` with the plan), "packer" (``BatchPacker.pack_sharded``
of the global batch at the bucket K ``freeze_shapes`` froze for the pass
on every rank alike, the rank's block kept) and "slow"
(``pack_batch_sharded``); in the join phase "resident_pv" (the rank's
block of a ``PvPlan`` built for ``n_devices = world``), "pv_packer" (``pack_sharded`` of the
plan's global batches, the rank's block of their ``ins_weight`` and
``rank_offset`` kept) and "pv_records" (``pv_batches(n_devices=world)``
through ``pack_batch_sharded``). A single host needs no lockstep: the
plan's ghost-batch floor is 0. Before a pass's first step the ranks
all-gather ``dataset.replica_digest()`` (with the options that add
collectives: a registry, a dump) and raise on a mismatch; that first pass
also binds the dataset to the plan (``dataset.mesh_plan``), so its
``end_pass`` can carry a rank's shard. The AUC is read through
``auc_psum``; kstep averages the replicas at the pass's end
(``kstep_sync_params``; the optimizer state becomes rank 0's, as the JAX
package keeps device 0's); ZeRO-1's chunk states are all-gathered into
the stacked state at the pass's end, so ``save_dense`` writes the JAX
package's ZeRO file. ``trained_table()`` all-gathers the shards
([world, cap, width] on every rank, so every rank's end_pass writes the
same rows and the host tables stay replicas); ``trained_table_device()``
is this rank's shard, which ``end_pass`` carries (``table/carrier.py``).

Every rank passes the same options. On a mesh:

- a metric registry or a dump all-gathers each kept batch's per-instance
  outputs (``preds``, ``labels``: one collective a step, only with such a
  consumer), so every rank's registry sees the global batch in the JAX
  package's device-major order beside the global ``cmatch``, ``rank``
  and ``ins_weight``, and reads the same; rank 0 alone writes the dump
  (each line once) and the pass-end param dump;
- async dense has one ``AsyncDenseTable``, rank 0's (the other ranks may
  pass None): before every batch rank 0 pulls its params and
  ``MeshPlan.broadcast`` hands them to every rank bit for bit, so the
  ranks never train on different params; after the batch rank 0 pushes
  the step's globally reduced gradients. Replicated tables would drift:
  each applies its pushes on its own thread.

Spans (``utils/trace.py``; they also enter a recording ``torch.profiler``
trace). The JAX trainer's names: ``pack+upload`` on the packer feed's
workers (when the profiler is enabled), ``feed_wait`` and
``train_step_dispatch`` per batch of a host feed, ``resident_prepare``
and ``superstep_dispatch`` on the resident feeds, and, only under
``profile``, ``device_step`` / ``device_superstep``. The port's own tile
a call's edges: ``train_pass.open`` (the state, the first AUC read, the
feed's choice), ``resident_prepare``'s children on the flat resident feed
(``resident.batch_indices``, ``resident.ensure_pads``,
``resident.index_partition``) and on both (``resident.superstep_build``),
and ``train_pass.close`` (the pass-end bookkeeping, two ``auc_compute``,
the reads). Category ``sync`` holds one span a blocking wait or device
read, and nothing else: ``device_step`` / ``device_superstep`` under
``profile``; else ``sync.superstep`` (a step ahead past
``max_inflight_steps``, or a superstep ahead) and ``sync.drain`` (the
call's last step, after its last yield); ``sync.auc_tables`` (one a
table, two at each end of a call), ``sync.losses`` and ``sync.nan_flags``
(at the close, and a batch's flag where a consumer needs it). A sync span
is recorded on the CPU too, where it waits on nothing, so a call's count
is the same on every device. The fault site ``step.device`` fires before
every dispatch.

Over several hosts (the dataset's ``transport`` spans more than one rank)
the port runs one process a card, so a host is one mesh rank: its
transport rank is its mesh rank (checked) and it owns mesh shard ``rank``
of the pass table, which it holds alone (a ``DistributedWorkingSet``
pass). Each rank loads only its stripe of the files, so
``dataset.batch_size`` is ``cfg.batch_size``, and the global batch is the
hosts' blocks in rank order::

    role = init_distributed(backend="nccl"); tp = role.host_transport()
    plan = make_mesh("nccl")
    dataset = BoxPSDataset(schema, table, b, n_mesh_shards=plan.world,
                           rank=plan.rank, nranks=plan.world, transport=tp)
    trainer = CTRTrainer(model, cfg, plan=plan)      # cfg.batch_size = b
    ... the same pass loop; end_pass(trainer.trained_table())

Every rank packs only its own batch (``n_devices`` 1) and the counts and
shapes the ranks must share go over the transport, in the same order on
every rank: the resident gate (``res-gate``: one rank that cannot take
the resident feed sends all to the packer), the resident pass's sizes and
pads, the packer's ``freeze-L`` / ``freeze-K``, the batch count and the
join phase's (``_pv_locked_plan``: ``num_pv_batches(global_count=True)``,
cached per pvs, so a rank that hits the cache skips the round on every
rank alike; short hosts run ghost batches). The feeds are the store-backed
ones ("resident", "packer", "resident_pv", "pv_packer"); a pass held as
SlotRecords raises, as in the JAX package (its pads are not locksteped).
``trained_table()`` is this rank's block [1, cap, width], which its
``end_pass`` writes back into its own host table; ``trained_table_device()``
its shard, which ``end_pass`` carries in a ``MultiHostCarrier``. A
``PassSupervisor`` over several hosts takes each rank's transport and
keeps the ranks' passes in lockstep through its verdict exchange. Async
dense, a metric registry and a dump over several hosts are refused, as
the JAX trainer cannot run them over several processes either (ROADMAP
Queue 4).
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.dataset import BoxPSDataset
from paddlebox_tpu_torch.data.device_pack import BatchPacker, pack_batch, pack_batch_sharded
from paddlebox_tpu_torch.data.pipeline import prefetch
from paddlebox_tpu_torch.fleet.zero import Zero1Optimizer
from paddlebox_tpu_torch.metrics.auc import AucState, auc_compute, auc_init, auc_psum
from paddlebox_tpu_torch.train.async_dense import AsyncDenseTable
from paddlebox_tpu_torch.train.dense_opt import Adam, MultiStepsState, tree_map
from paddlebox_tpu_torch.metrics.registry import MetricRegistry
from paddlebox_tpu_torch.parallel.mesh import MeshPlan
from paddlebox_tpu_torch.train.resident_step import (
    ResidentFeed,
    ResidentPass,
    count_pooled,
    ensure_sharded,
    make_resident_superstep,
)
from paddlebox_tpu_torch.train.sharded_step import (
    init_sharded_train_state,
    kstep_sync_params,
    make_sharded_train_step,
)
from paddlebox_tpu_torch.train.train_step import TrainState, TrainStepConfig, make_train_step
from paddlebox_tpu_torch.utils.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.utils.dump import DumpWorkerPool, dump_fields, dump_param
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire
from paddlebox_tpu_torch.utils.fs import atomic_write
from paddlebox_tpu_torch.utils.trace import PROFILER

config.define_flag(
    "max_inflight_steps",
    4,
    "cap on dispatched-but-unfinished device steps; 0 = unbounded. Deep "
    "enough to hide the host's next batch behind the device step, shallow "
    "enough that work cannot pile up",
)

# host seconds of train_pass(profile=True): waiting for the feed, handing
# work to the device, waiting for the device, and the per-batch consumers
_PROFILE_KEYS = ("feed_wait_s", "step_dispatch_s", "device_step_s", "host_metrics_s")
# the slow feed splits its feed wait further
_SLOW_FEED_KEYS = ("build_batch_s", "pack_batch_s", "h2d_s")


def _clone_opt_state(st: Any) -> Any:
    return tree_map(torch.clone, st)


def _no_span(name: str, category: str):
    return nullcontext()


class CTRTrainer:
    def __init__(
        self,
        model: torch.nn.Module,
        cfg: TrainStepConfig,
        dense_opt: Optional[Adam] = None,
        device: Optional[DeviceLike] = None,
        metric_registry: Optional[MetricRegistry] = None,
        dense_slot: Optional[str] = None,
        dense_dim: int = 0,
        pack_bucket: Optional[int] = None,
        async_dense: Optional[AsyncDenseTable] = None,
        dump_pool: Optional[DumpWorkerPool] = None,
        dump_fields_list: Sequence[str] = ("preds", "labels"),
        dump_mode: int = 0,  # 0 all, 1 sampled by ins_id hash, 2 every Nth batch
        dump_interval: int = 1,
        dump_params_at_end: bool = False,
        box=None,  # a BoxWrapper whose test_mode gates eval
        plan: Optional[MeshPlan] = None,
    ):
        """``model(slot_feats, dense) -> logits`` (a zoo model, e.g.
        ``models.DeepFM``; with ``cfg.model_takes_rank_offset``,
        ``model(slot_feats, dense, rank_offset)``, e.g.
        ``models.RankDeepFM``) moves to ``device``; its current weights are
        the initial params. ``dense_opt`` defaults to ``Adam(1e-3)``.
        ``device`` defaults to "cuda" and raises on a host without a GPU;
        with a mesh ``plan`` it is the plan's (a different one raises),
        and ``cfg.batch_size`` is a rank's share of the dataset's batch.
        ``metric_registry`` (on the same device) is fed every batch's
        outputs. The other options are the JAX trainer's (module
        docstring); ``dense_sync_mode="async"`` without ``async_dense``
        raises (on a mesh, on rank 0)."""
        if cfg.dense_sync_mode == "async" and async_dense is None and (plan is None or plan.rank == 0):
            raise ValueError(
                "dense_sync_mode='async' needs an AsyncDenseTable (else the dense "
                "params would never update)"
            )
        self.plan = plan
        if isinstance(dense_opt, Zero1Optimizer) and plan is None:
            raise ValueError(
                "Zero1Optimizer (the sharding strategy) needs a mesh plan: its "
                "optimizer state lives sharded over the ranks"
            )
        if plan is not None:
            if device is not None and resolve_device(device) != plan.device:
                raise ValueError(f"device {device} is not the plan's {plan.device}")
            self.device = plan.device
        else:
            self.device = resolve_device("cuda" if device is None else device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.dense_opt = dense_opt or Adam(1e-3)
        self.metric_registry = metric_registry
        self.dense_slot = dense_slot
        self.dense_dim = dense_dim
        self.pack_bucket = pack_bucket
        self.async_dense = async_dense
        # per-batch field and pass-end param dumps (DeviceWorker::DumpField /
        # DumpParam, device_worker.cc:98-133; modes device_worker.h:218-219)
        self.dump_pool = dump_pool
        self.dump_fields_list = tuple(dump_fields_list)
        self.dump_mode = dump_mode
        self.dump_interval = dump_interval
        self.dump_params_at_end = dump_params_at_end
        self.box = box
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.opt_state: Any = None  # the dense optimizer's state (AdamState, MultiStepsState)
        self._state: Optional[TrainState] = None
        self._state_ws = None
        self._packer_cache = None  # (store, ws, BatchPacker)
        # the resident feed's pass-scoped state: its ResidentPass, index
        # partition, pv plan and supersteps (None until a resident pass)
        self.resident: Optional[ResidentFeed] = None
        # SetTestMode (box_wrapper.cc:623): the next train_pass calls run
        # the eval step until cleared
        self.test_mode = False
        self._eval_step_fn = None
        self.last_feed: Optional[str] = None  # the feed the last train_pass took
        self.last_prepare_s = 0.0
        # prepare_pass's seconds on the resident feed: the row stream's
        # resolve and upload (a new ResidentPass), the batch partition, its
        # pad stats (ResidentPass.ensure) and the index partition's upload
        self.last_prepare_parts: Dict[str, float] = {}

        def model_apply(params, slot_feats, dense, *extra):
            return functional_call(self.model, params, (slot_feats, dense, *extra))

        self._model_apply = model_apply
        self._digest_ws = None  # the working set whose replica digest was checked
        self._multi_pass = False  # the last pass ran over several hosts
        self._pv_minb_cache = None  # (pvs, n_dev, agreed batch count) over several hosts
        self._pads_ws = None  # the slow mesh feed's sticky pads: (ws, [K, L])
        if plan is None:
            self._step = make_train_step(model_apply, cfg, self.dense_opt)
        else:
            self._step = make_sharded_train_step(model_apply, self.dense_opt, cfg, plan)

    # ---- eval mode -------------------------------------------------------

    def set_test_mode(self, on: bool = True) -> None:
        """SetTestMode parity: the next train_pass calls run forward and
        metrics only (no sparse push, no dense update) until cleared."""
        self.test_mode = on

    @property
    def _eval_active(self) -> bool:
        """Test mode, set on the trainer or on its ``box``."""
        return self.test_mode or bool(self.box is not None and self.box.test_mode)

    def _step_fn(self, eval_mode: bool):
        if not eval_mode:
            return self._step
        if self._eval_step_fn is None:
            if self.plan is None:
                self._eval_step_fn = make_train_step(self._model_apply, self.cfg, eval_mode=True)
            else:
                self._eval_step_fn = make_sharded_train_step(
                    self._model_apply, self.dense_opt, self.cfg, self.plan, eval_mode=True
                )
        return self._eval_step_fn

    # ---- dense param lifecycle ------------------------------------------

    def init_params(self) -> None:
        """Params from the model's current weights; a fresh optimizer state."""
        self.params = {
            k: v.detach().clone().to(self.device) for k, v in self.model.state_dict().items()
        }
        if isinstance(self.dense_opt, Zero1Optimizer):
            self.opt_state = self.dense_opt.init_stacked(self.params)
        else:
            self.opt_state = self.dense_opt.init(self.params)

    def drop_device_state(self) -> None:
        """Forget every device-side cache: the pass state (table, params and
        optimizer copies), the packer, the resident pass, its supersteps,
        its index partition and its pv plan. The next train_pass starts
        from ``self.params`` / ``self.opt_state``."""
        if self._packer_cache is not None:
            self._packer_cache[2].close()
        self._state = self._state_ws = None
        self._packer_cache = self.resident = None

    def save_dense(self, path: str) -> None:
        """Dense checkpoint (boxps_trainer.cc:123-131 parity) in the JAX
        package's format: ``leaf_0`` .. ``leaf_{n-1}`` of its ``(params,
        optax state)`` tree (Adam's, or ``MultiSteps`` of Adam's), weights
        as [in, out], plus a ``treedef``
        string naming each leaf. Written through ``atomic_write``, so a
        crash cannot tear a file a cursor already names."""
        from paddlebox_tpu_torch.models.convert import dense_leaf_names, dense_to_jax_leaves

        path = path if path.endswith(".npz") else path + ".npz"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        leaves = dense_to_jax_leaves(self.params, self.opt_state)
        with atomic_write(path, "wb") as f:
            np.savez_compressed(
                f,
                treedef=";".join(dense_leaf_names(
                    self.params, zero=isinstance(self.dense_opt, Zero1Optimizer),
                    multi_steps=isinstance(self.opt_state, MultiStepsState),
                )),
                **{f"leaf_{i}": x for i, x in enumerate(leaves)},
            )

    def load_dense(self, path: str) -> None:
        """Read a dense checkpoint of either package onto ``self.device``;
        raises ``ValueError`` on a leaf count or a shape that differs from
        the current params, or an optimizer state of another kind than
        this trainer's. Drops the device-side caches."""
        from paddlebox_tpu_torch.models.convert import dense_from_jax_leaves

        if self.params is None:
            raise RuntimeError("init_params first (defines the tree structure)")
        path = path if path.endswith(".npz") else path + ".npz"
        with np.load(path, allow_pickle=False) as data:
            n_saved = sum(1 for k in data.files if k.startswith("leaf_"))
            leaves = [data[f"leaf_{i}"] for i in range(n_saved)]
        params, opt_state = dense_from_jax_leaves(leaves, self.params, self.device)
        if type(opt_state) is not type(self.opt_state):
            raise ValueError(
                f"the checkpoint holds a {type(opt_state).__name__} but this trainer's dense "
                f"optimizer keeps a {type(self.opt_state).__name__}"
            )
        self.params, self.opt_state = params, opt_state
        self.drop_device_state()

    # ---- pass loop -------------------------------------------------------

    def _make_state(self, dev_table, ws_key=None) -> TrainState:
        # later train_pass calls within one pass (same working set) must see
        # the rows the earlier calls trained: rebuild only when it changes
        if self._state is not None and ws_key is not None and self._state_ws is ws_key:
            return self._state
        self._state_ws = ws_key
        if self.params is None:
            self.init_params()
        # the step updates the table in place: copy, so the dataset's pass
        # table (a host array or a device tensor: the spliced table, or one
        # a handoff shares with the trainer before) stays as it is. Params
        # and optimizer state are copies too, so a failed pass leaves
        # self.params as they were.
        if self.plan is not None:
            return init_sharded_train_state(
                self.plan, dev_table, self.params, self.dense_opt, self.cfg.auc_buckets,
                opt_state=self.opt_state, local_dense=self.cfg.dense_sync_mode == "kstep",
            )
        if not isinstance(dev_table, torch.Tensor):
            dev_table = torch.from_numpy(dev_table)
        table = dev_table.reshape(-1, dev_table.shape[-1])
        return TrainState(
            table=table.to(self.device, copy=True),
            params={k: v.clone() for k, v in self.params.items()},
            opt_state=_clone_opt_state(self.opt_state),
            auc=auc_init(self.cfg.auc_buckets, device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def _mark(self) -> Optional[torch.cuda.Event]:
        """An event after the work queued so far (None on the CPU, where
        every step has finished when it returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @staticmethod
    def _wait(ev: Optional[torch.cuda.Event], span: str, tm: Dict[str, float]) -> None:
        """Wait for the work before ``ev`` inside the ``sync`` span
        ``span``: one span a blocking wait, recorded on the CPU too (where
        ``ev`` is None and nothing waits), so a call's count of them is
        the same on every device."""
        t0 = time.perf_counter()
        with PROFILER.record_event(span, "sync"):
            if ev is not None:
                ev.synchronize()
        tm["device_step_s"] += time.perf_counter() - t0

    # ---- feeds -------------------------------------------------------------
    # Each feed yields (device batch, registry inputs). The registry's
    # inputs (cmatch, rank, ins_weight) are gathered only when a registry
    # is attached, and travel to the device the way the batch does.

    def _to_device(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device, non_blocking=True) for k, v in host.items()}

    def _host(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host tensors of ``arrays``, pinned when the device is a GPU (so
        the dispatch thread's copy is asynchronous)."""
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        return {k: v.pin_memory() for k, v in host.items()} if self.device.type == "cuda" else host

    def _logkey_aux(self, cmatch, rank) -> Dict[str, np.ndarray]:
        """The registry's logkey inputs of a batch (none without a registry
        or without logkey columns)."""
        if self.metric_registry is None or cmatch is None:
            return {}
        return {"cmatch": cmatch, "rank": rank}

    def _with_ids(self, aux: Dict, ins_ids) -> Dict:
        """``aux`` with the batch's instance ids, which only a dump reads."""
        if self.dump_pool is not None and ins_ids is not None:
            aux["ins_ids"] = ins_ids
        return aux

    def _wants_ids(self, store) -> bool:
        """A dump reads instance ids, and ``store`` parsed them."""
        return self.dump_pool is not None and store.ins_id_off is not None

    def _store_ids(self, store, idx):
        """The instance ids of records ``idx`` of a store, when a dump wants
        them (else None)."""
        return [store.ins_id(int(j)) for j in idx] if self._wants_ids(store) else None

    def _multi(self, dataset: BoxPSDataset) -> bool:
        """A mesh over several hosts: each rank packs only its own batch."""
        return self.plan is not None and dataset.multi_host

    def _n_pack(self, dataset: BoxPSDataset) -> int:
        """The devices this rank packs batches for: none on one device (0),
        every rank of a single-host mesh, its own block over several hosts."""
        if self.plan is None:
            return 0
        return 1 if self._multi(dataset) else self.plan.world

    def _lockstep(self, dataset: BoxPSDataset):
        """The transport the pads are all-reduced over (None on one host)."""
        return dataset.transport if self._multi(dataset) else None

    def _pack(self, batch, dataset: BoxPSDataset) -> Dict[str, np.ndarray]:
        """``pack_batch`` of a SlotBatch with the trainer's dense slot and
        pad bucket; on a mesh ``pack_batch_sharded`` of the global batch,
        this rank's block, its K and L pads sticky over the working set
        (so a pass keeps one shape)."""
        if self.plan is None:
            return pack_batch(
                batch, dataset.ws, dataset.schema, dense_slot=self.dense_slot, dense_dim=self.dense_dim,
                bucket=self.pack_bucket,
            ).as_dict()
        if self._pads_ws is None or self._pads_ws[0] is not dataset.ws:
            self._pads_ws = (dataset.ws, [-1, 0])  # [k_floor (-1: headroom), l_floor]
        pads = self._pads_ws[1]
        db = pack_batch_sharded(
            batch, dataset.ws, dataset.schema, self.plan.world, dense_slot=self.dense_slot,
            dense_dim=self.dense_dim, bucket=self.pack_bucket, k_floor=pads[0], l_floor=pads[1],
        )
        pads[:] = [db.req_ranks.shape[2], db.inverse.shape[1]]
        return self._rank_block(db)

    def _rank_block(self, db) -> Dict[str, np.ndarray]:
        """This rank's block of a ShardedDeviceBatch's arrays (its only one
        when it packed for one device, over several hosts)."""
        blk = 0 if db.req_ranks.shape[0] == 1 else self.plan.rank
        return {k: v[blk] for k, v in db.as_dict().items()}

    def _slow_feed_iter(self, dataset: BoxPSDataset, n_batches, profile, tm):
        """Build, pack and copy each batch on the dispatch thread. With
        ``profile`` each stage's host seconds add up in ``tm`` (the copy
        waits for the device)."""
        it = iter(dataset.batches(n_batches))
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter()
            arrays = self._pack(batch, dataset)
            t2 = time.perf_counter()
            feed = {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}
            aux = {
                k: torch.from_numpy(v).to(self.device)
                for k, v in self._logkey_aux(batch.cmatch, batch.rank).items()
            }
            aux = self._with_ids(aux, batch.ins_ids)
            if profile:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                tm["build_batch_s"] += t1 - t0
                tm["pack_batch_s"] += t2 - t1
                tm["h2d_s"] += time.perf_counter() - t2
            yield feed, aux

    def _get_packer(self, dataset: BoxPSDataset) -> BatchPacker:
        """One BatchPacker per (store, working set): its pad shapes stay
        frozen across train_pass calls within a pass."""
        c = self._packer_cache
        if c is not None and c[0] is dataset.store and c[1] is dataset.ws:
            return c[2]
        if c is not None:
            c[2].close()
        packer = BatchPacker(
            dataset.store, dataset.ws, dataset.schema, dense_slot=self.dense_slot, dense_dim=self.dense_dim,
            bucket=self.pack_bucket,
        )
        self._packer_cache = (dataset.store, dataset.ws, packer)
        return packer

    def _store_logkeys(self, store, idx):
        """(cmatch, rank) of records ``idx`` of a store that parsed them."""
        if store.ins_id_off is None:
            return None, None
        return store.cmatch[idx], store.rank[idx]

    def _fast_feed_iter(self, dataset: BoxPSDataset, n_batches):
        """Native pack in prefetch threads, overlapped with the device step.
        The workers also pin each batch; the copy to the device is issued
        here, on the dispatch thread, ``non_blocking`` from the pinned
        memory, so it is queued behind the steps and the host never waits
        for it."""
        packer = self._get_packer(dataset)
        world = self._n_pack(dataset)
        packer.freeze_shapes(dataset.batch_indices(n_batches), n_devices=world, transport=self._lockstep(dataset))
        store = dataset.store

        def prep(idx):
            aux = self._logkey_aux(*self._store_logkeys(store, idx))
            if self.plan is None:
                arrays = packer.pack(idx).as_dict()
            else:  # the whole global batch packs; this rank keeps its block
                arrays = self._rank_block(packer.pack_sharded(idx, world))
            # the ids' strings are built here, off the dispatch thread
            return self._host(arrays), self._host(aux), self._store_ids(store, idx)

        def prep_traced(idx):
            # the worker thread's span: a trace shows the pack beside the
            # device step (the copy to the device is the dispatch thread's)
            if not PROFILER.enabled:
                return prep(idx)
            with PROFILER.record_event("pack+upload", "pack"):
                return prep(idx)

        for host, aux, ids in prefetch(dataset.batch_indices(n_batches), prep_traced):
            yield self._to_device(host), self._with_ids(self._to_device(aux), ids)

    def _pv_locked_plan(self, dataset: BoxPSDataset):
        """The pass's PvPlan, the one source of the join phase's gate,
        prepare and feeds, blocked for the devices this rank packs for (one
        device, or over several hosts: 1; a single-host mesh: world). A
        single host needs no ghost batches (``min_batches`` 0). Over several
        hosts the global batch count is all-reduced (max) over the
        transport once a (pvs, devices) and cached: every rank takes the
        cache hit at the same call, so a rank never skips a round another
        enters (the JAX package's rule), and short hosts pad with
        all-ghost batches."""
        n_dev = max(1, self._n_pack(dataset))
        if not self._multi(dataset):
            return dataset.pv_plan(n_dev, min_batches=0)
        c = self._pv_minb_cache
        if c is not None and c[0] is dataset.pvs and c[1] == n_dev:
            min_b = c[2]
        else:
            min_b = dataset.num_pv_batches(n_devices=n_dev, global_count=True)
            self._pv_minb_cache = (dataset.pvs, n_dev, min_b)
        return dataset.pv_plan(n_dev, min_batches=min_b)

    def _pv_block(self, w: np.ndarray, ro: np.ndarray):
        """A global pv batch's ``ins_weight`` [B] and ``rank_offset`` [B, R]
        as this rank's blocks (the rank matrices are block-local already);
        unchanged on one device."""
        if self.plan is None or len(w) == self.cfg.batch_size:
            return w, ro  # one device, or the rank's own batch (several hosts)
        b = len(w) // self.plan.world
        lo = self.plan.rank * b
        return w[lo : lo + b], ro[lo : lo + b]

    def _pv_plan_feed_iter(self, dataset: BoxPSDataset, plan, n_batches):
        """The join phase's packer feed: the plan's record indices packed
        natively in prefetch threads (which pin them, with the batch's rank
        matrix and ghost weights), copied as ``_fast_feed_iter`` copies.
        At most ``n_batches`` of the plan's batches (no wrap-around). On a
        mesh the global batch packs and this rank keeps its block."""
        packer = self._get_packer(dataset)
        world = self._n_pack(dataset)
        packer.freeze_shapes(plan.idx, n_devices=world, transport=self._lockstep(dataset))
        store = dataset.store
        n = plan.n_batches if n_batches is None else min(plan.n_batches, n_batches)

        def prep(pos):
            idx = plan.idx[pos]
            if self.plan is None:
                arrays = packer.pack(idx).as_dict()
            else:
                arrays = self._rank_block(packer.pack_sharded(idx, world))
            w = plan.ins_weight[pos]
            arrays["ins_weight"], arrays["rank_offset"] = self._pv_block(w, plan.rank_offset[pos])
            aux = self._pv_aux(self._logkey_aux(*self._store_logkeys(store, idx)), w)
            return self._host(arrays), self._host(aux), self._store_ids(store, idx)

        for host, aux, ids in prefetch(range(n), prep):
            yield self._to_device(host), self._with_ids(self._to_device(aux), ids)

    def _pv_aux(self, aux: Dict, w: np.ndarray) -> Dict:
        """``aux`` with the global batch's ghost weights, which only a
        registry reads."""
        if self.metric_registry is not None:
            aux["ins_weight"] = w
        return aux

    def _pv_feed_iter(self, dataset: BoxPSDataset, n_batches):
        """The join phase's record-level feed, for a pass held as
        SlotRecords: ``pv_batches`` (blocked for the mesh's ranks) built on
        the dispatch thread, packed and pinned by ONE prefetch worker (the
        order stays the pass's and the mesh's sticky pads race-free),
        copied as the other host feeds copy."""

        def prepare(item):
            batch, weight = item
            arrays = self._pack(batch, dataset)
            arrays["ins_weight"], arrays["rank_offset"] = self._pv_block(weight, batch.rank_offset)
            aux = self._pv_aux(self._logkey_aux(batch.cmatch, batch.rank), weight)
            return self._host(arrays), self._host(aux), batch.ins_ids

        n_dev = 1 if self.plan is None else self.plan.world
        for host, aux, ids in prefetch(dataset.pv_batches(n_batches, n_devices=n_dev), prepare, workers=1, depth=2):
            yield self._to_device(host), self._with_ids(self._to_device(aux), ids)

    def _classic_stepper(self, iterator, holder, step_fn, profile, tm, is_async=False):
        """Per-batch dispatch over a host-packed feed. Yields (i, metrics,
        registry inputs). With ``is_async`` each step starts from a copy of
        the async dense table's params (PullDense)."""
        max_inflight = int(config.get_flag("max_inflight_steps"))
        inflight: deque = deque()
        it = iter(iterator)
        i = 0
        ev = None
        while True:
            t0 = time.perf_counter()
            try:
                with PROFILER.record_event("feed_wait", "pass"):
                    feed, aux = next(it)
            except StopIteration:
                if i and not profile:
                    self._wait(ev, "sync.drain", tm)  # see the resident stepper's
                return
            finally:
                tm["feed_wait_s"] += time.perf_counter() - t0
            if is_async:
                holder["state"] = holder["state"]._replace(params=self._async_params(holder["state"].params))
            # the chaos seam: a device failure of a step (out of memory, a
            # lost card) surfaces here as a dispatch exception
            _fault_fire("step.device")
            t0 = time.perf_counter()
            with PROFILER.record_event("train_step_dispatch", "pass"):
                holder["state"], m = step_fn(holder["state"], feed)
                ev = self._mark()
            tm["step_dispatch_s"] += time.perf_counter() - t0
            if profile:
                # every step waits: asked for by profile
                self._wait(ev, "device_step", tm)
            elif max_inflight:
                inflight.append(ev)
                if len(inflight) > max_inflight:
                    self._wait(inflight.popleft(), "sync.superstep", tm)
            yield i, m, aux
            i += 1

    # ---- the resident feeds ------------------------------------------------

    def _use_resident(self, dataset: BoxPSDataset, use_pv: bool, is_async: bool = False) -> bool:
        """One predicate for the resident-vs-host choice, shared by
        train_pass and prepare_pass. Async dense pulls and pushes every
        batch, so it stays on the host feeds. The join phase needs the
        pass's plan (every record's store index); a model that takes
        ``rank_offset`` stays off the flat tier, which has no rank matrix
        to feed it.

        Over several hosts the inputs (store size, store presence) can
        differ by host, and a split decision would send the hosts into
        different lockstep rounds (the packer's freeze against the
        resident pass's): every host takes the resident feed only when all
        can (``res-gate``, one round a call; the call sequence is alike on
        every host)."""
        ok = (
            bool(config.get_flag("enable_resident_feed"))
            and not is_async
            and dataset.store is not None
            and len(dataset.store.u64_values) < (1 << 31)
        )
        if self._multi(dataset):
            ok = dataset.transport.allreduce_max(0 if ok else 1, "res-gate") == 0
        if not ok:
            return False
        if use_pv:
            return self._pv_locked_plan(dataset) is not None
        return not self.cfg.model_takes_rank_offset

    def _get_resident(self, dataset: BoxPSDataset) -> ResidentFeed:
        """The pass-scoped ResidentFeed, rebuilt when the store or working
        set changes. The previous pass's device arrays are released first,
        so two passes' arrays never sit on the device together."""
        res = self.resident
        if res is not None and res.rp.store is dataset.store and res.rp.ws is dataset.ws:
            return res
        # a rebuild over the same store keeps the unique-row counts of its
        # index blocks: distinct keys map to distinct rows in any working set
        prev_uniq = res.rp._uniq_cache if res is not None and res.rp.store is dataset.store else None
        res = self.resident = None  # a live reference would keep the old arrays on the device
        rp = ResidentPass(
            dataset.store, dataset.ws, dataset.schema, self.device, dense_slot=self.dense_slot,
            dense_dim=self.dense_dim, bucket=self.pack_bucket, plan=self.plan,
            transport=self._lockstep(dataset),
        )
        if prev_uniq:
            rp._uniq_cache.update(prev_uniq)
        self.resident = ResidentFeed(rp)
        return self.resident

    def _resident_prepare(self, dataset: BoxPSDataset, use_pv: bool, n_batches, traced: bool):
        """The resident prepare of prepare_pass and train_pass: the pass's
        ResidentFeed, the batches' record indices (the join phase: its
        plan's), the pads grown over them and their upload, the index
        partition or the plan. Returns (ResidentFeed, the host record
        indices [n, B], each stage's seconds under its
        ``last_prepare_parts`` name). ``traced`` puts the flat tier's
        stages in spans."""
        span = PROFILER.record_event if traced else _no_span
        t = [time.perf_counter()]
        res = self._get_resident(dataset)
        t.append(time.perf_counter())
        if use_pv:
            names = ("resident_upload_s", "pv_plan_s", "pad_stats_s", "pv_upload_s")
            plan = self._pv_locked_plan(dataset)
            host_idx = plan.idx
            t.append(time.perf_counter())
            # ghosts repeat records: they add keys, no unique rows
            self._ensure_pads(res.rp, host_idx)
            t.append(time.perf_counter())
            res.load_pv(plan, self.plan)
        else:
            names = ("resident_upload_s", "batch_indices_s", "pad_stats_s", "index_partition_s")
            with span("resident.batch_indices", "pass"):
                host_idx = [np.asarray(b, dtype=np.int32) for b in dataset.batch_indices(n_batches)]
            t.append(time.perf_counter())
            with span("resident.ensure_pads", "pass"):
                self._ensure_pads(res.rp, host_idx)
            t.append(time.perf_counter())
            with span("resident.index_partition", "pass"):
                res.index_partition(host_idx)
        t.append(time.perf_counter())
        return res, host_idx, {k: b - a for k, a, b in zip(names, t, t[1:])}

    def _resident_stepper(self, dataset: BoxPSDataset, n_batches, holder, eval_mode, profile, tm, use_pv):
        """Superstep dispatch: K batches a call. The flat tier's feed is a
        slice of the resident index partition; the join tier's (``use_pv``)
        a slice of the resident plan's batch positions, its rank matrices
        and weights riding along on the device. Yields (i, metrics,
        registry inputs) like the classic stepper; each metric is a view
        of the chunk's stacked output, and each registry input a device
        slice, so nothing is read back unless a consumer reads it. With
        ``profile`` every dispatch is one batch and waits for the device
        (per-batch attribution, as the JAX package does)."""
        t0 = time.perf_counter()
        with PROFILER.record_event("resident_prepare", "pass"):
            res, host_idx, _ = self._resident_prepare(dataset, use_pv, n_batches, True)
            n = len(host_idx) if n_batches is None else min(len(host_idx), n_batches)
            pv_feed = w_dev = None
            feed_dev = rows_dev = res.index
            if use_pv:
                pv_feed = res.pv_feed
                # the registry reads the global batch (on a mesh, beside the
                # rank's blocks the step reads)
                feed_dev, rows_dev, w_dev = pv_feed.positions, pv_feed.global_idx, pv_feed.global_ins_weight
            with PROFILER.record_event("resident.superstep_build", "pass"):
                sstep = res.steps.get((use_pv, eval_mode))
                if sstep is None:
                    sstep = res.steps[use_pv, eval_mode] = make_resident_superstep(
                        self._model_apply, self.dense_opt, self.cfg, res.rp, eval_mode, plan=self.plan,
                        pv_feed=pv_feed,
                    )
            logkeys = None
            if self.metric_registry is not None and dataset.store.ins_id_off is not None:
                logkeys = res.rp.logkey_columns()
        tm["feed_wait_s"] += time.perf_counter() - t0
        K = 1 if profile else max(1, int(config.get_flag("resident_scan_batches")))
        # a dump's instance ids are built off the dispatch thread: one
        # worker resolves a chunk's ids while its superstep runs
        ids_ex = ThreadPoolExecutor(max_workers=1) if self._wants_ids(dataset.store) else None
        try:
            inflight: deque = deque()
            i = 0
            ev = None
            for c0 in range(0, n, K):
                k = min(K, n - c0)
                ids_fut = None
                if ids_ex is not None:
                    ids_fut = ids_ex.submit(
                        lambda c0, k: [self._store_ids(dataset.store, host_idx[c0 + j]) for j in range(k)], c0, k
                    )
                _fault_fire("step.device")  # the chaos seam (see the classic stepper)
                t0 = time.perf_counter()
                with PROFILER.record_event("superstep_dispatch", "pass"):
                    holder["state"], mstack = sstep(holder["state"], feed_dev[c0 : c0 + k])
                    ev = self._mark()
                if self.plan is None:
                    count_pooled(res.rp, c0, k)
                tm["step_dispatch_s"] += time.perf_counter() - t0
                if profile:
                    self._wait(ev, "device_superstep", tm)
                else:
                    inflight.append(ev)
                    if len(inflight) > 1:  # one superstep ahead
                        self._wait(inflight.popleft(), "sync.superstep", tm)
                chunk_ids = ids_fut.result() if ids_fut is not None else None
                for j in range(k):
                    aux = {}
                    if logkeys is not None:
                        rows = rows_dev[c0 + j]
                        aux["cmatch"] = logkeys[0].index_select(0, rows)
                        aux["rank"] = logkeys[1].index_select(0, rows)
                    if pv_feed is not None and self.metric_registry is not None:
                        aux["ins_weight"] = w_dev[c0 + j]
                    if chunk_ids is not None:
                        aux["ins_ids"] = chunk_ids[j]
                    yield i, {key: v[j] for key, v in mstack.items()}, aux
                    i += 1
            if n and not profile:
                # the wait on the last superstep, after its last yield: the
                # card's tail of the queue lands here, not in the host work
                # of train_pass.close (whose first read would wait for it)
                self._wait(ev, "sync.drain", tm)
        finally:
            if ids_ex is not None:
                ids_ex.shutdown(wait=False)

    def prepare_pass(self, dataset: BoxPSDataset, n_batches: Optional[int] = None) -> None:
        """Freeze this pass's pad shapes for a batch partition before a
        timed train_pass: the resident feed's L_pad/U_pad (and its index
        partition's upload, or in the join phase the plan's build and
        upload), or the packer's L_pad (the join phase's packer freezes at
        feed time). Its wall time lands in ``last_prepare_s``, the resident
        feeds' stages in ``last_prepare_parts``."""
        t0 = time.perf_counter()
        try:
            if dataset.store is None or dataset.ws is None:
                return
            use_pv = dataset.pv_merged and dataset.current_phase == 1
            is_async = self.cfg.dense_sync_mode == "async" and not self._eval_active
            if self._use_resident(dataset, use_pv, is_async):
                self.last_prepare_parts = self._resident_prepare(dataset, use_pv, n_batches, False)[2]
            elif not use_pv:  # the join phase's packer freezes at feed time
                self._get_packer(dataset).freeze_shapes(
                    dataset.batch_indices(n_batches), n_devices=self._n_pack(dataset),
                    transport=self._lockstep(dataset),
                )
        finally:
            self.last_prepare_s = time.perf_counter() - t0

    def _ensure_pads(self, rp: ResidentPass, blocks) -> None:
        """Grow the resident pads over a partition: L_pad/U_pad on one
        device, the per-rank L_pad and the bucket K_pad on a mesh."""
        if self.plan is None:
            rp.ensure(blocks)
        else:
            ensure_sharded(rp, blocks, 1 if rp.per_device else self.plan.world)

    def _check_replicas(self, dataset: BoxPSDataset) -> None:
        """Once a pass on a mesh: all-gather the ranks' replica digests
        (the pass's keys, its record order, the batch size) and whether
        each has a registry and a dump, and raise on a rank that differs,
        before any step could route wrongly or wait on a collective the
        others never make. Binds the dataset to the plan."""
        if self.plan is None or self._digest_ws is dataset.ws:
            return
        if self._multi(dataset):
            self._check_hosts(dataset)
            return
        if dataset.batch_size != self.cfg.batch_size * self.plan.world:
            raise ValueError(
                f"the dataset's batch {dataset.batch_size} is not world {self.plan.world} x "
                f"cfg.batch_size {self.cfg.batch_size}"
            )
        if dataset.ws.n_mesh_shards != self.plan.world:
            raise ValueError(
                f"the working set has {dataset.ws.n_mesh_shards} mesh shards, the mesh "
                f"{self.plan.world} ranks: BoxPSDataset(n_mesh_shards=world)"
            )
        if dataset.mesh_plan is not None and dataset.mesh_plan is not self.plan:
            raise ValueError("the dataset is bound to another mesh plan")
        opts = [self.metric_registry is not None, self.dump_pool is not None]
        mine = torch.from_numpy(np.concatenate([dataset.replica_digest(), np.array(opts, np.int64)])).to(self.device)
        every = self.plan.all_gather(mine).cpu().numpy()
        bad = [r for r in range(self.plan.world) if not np.array_equal(every[r, :3], every[0, :3])]
        if bad:
            raise RuntimeError(
                f"replica digest mismatch: ranks {bad} differ from rank 0 in the pass's "
                "keys, record order or batch size (every rank must load the same files "
                "with the same seed)"
            )
        bad = [r for r in range(self.plan.world) if not np.array_equal(every[r, 3:], every[0, 3:])]
        if bad:
            raise RuntimeError(
                f"ranks {bad} differ from rank 0 in having a metric registry or a dump: "
                "every rank passes the same options (each gathers the outputs they read)"
            )
        dataset.mesh_plan = self.plan
        self._digest_ws = dataset.ws

    def _check_hosts(self, dataset: BoxPSDataset) -> None:
        """Once a pass over several hosts: the rank checks. Row placement
        puts rank r's block at mesh shard r while the working set assigns
        ownership by transport rank, so the two must be one number (else
        every pull reads the wrong host's slice), and the rank must be live
        in the ownership map. The datasets are not replicas, so there is
        no digest to compare."""
        tp, ws = dataset.transport, dataset.ws
        if tp.rank != self.plan.rank or tp.n_ranks != self.plan.world:
            raise RuntimeError(
                f"transport rank {tp.rank} of {tp.n_ranks} != mesh rank {self.plan.rank} of "
                f"{self.plan.world}: order the transport endpoints by mesh rank"
            )
        omap = ws.ownership
        if not omap.is_live(tp.rank):
            raise RuntimeError(
                f"transport rank {tp.rank} is not in the live set of ownership epoch "
                f"{omap.epoch} (live={list(omap.live_ranks)}): it must not train"
            )
        if omap.range_of(tp.rank) != (self.plan.rank, self.plan.rank + 1):
            # an elastic shrink or grow hands a rank several shards (or
            # none); rank r's block sits at mesh shard r, and neither this
            # trainer nor the JAX one (process i's block at shard i) can
            # place more than one, so the elastic day runs on the host plane
            raise RuntimeError(
                f"rank {tp.rank} owns mesh shards {omap.range_of(tp.rank)} of ownership epoch "
                f"{omap.epoch}: one process a card places only its own shard {self.plan.rank}, "
                "so a rank whose range an elastic membership change moved cannot train on the mesh"
            )
        if dataset.store is None:
            raise RuntimeError(
                "training over several hosts needs the columnar store (its pad shapes "
                "are locksteped over the transport): enable the native parser"
            )
        if dataset.batch_size != self.cfg.batch_size:
            raise ValueError(
                f"over several hosts the dataset's batch {dataset.batch_size} is this "
                f"rank's block: cfg.batch_size {self.cfg.batch_size} must equal it"
            )
        if ws.n_mesh_shards != self.plan.world:
            raise ValueError(
                f"the working set has {ws.n_mesh_shards} mesh shards, the mesh "
                f"{self.plan.world} ranks: BoxPSDataset(n_mesh_shards=world)"
            )
        if self.async_dense is not None:
            # as the JAX package's train/trainer.py:108-115 refuses it:
            # each process would push globally reduced gradients into its
            # own host table
            raise NotImplementedError(
                "async dense over several hosts is refused, as the JAX trainer refuses it over "
                "several processes: ROADMAP Queue 4 item 1"
            )
        if self.metric_registry is not None or self.dump_pool is not None:
            # the JAX trainer feeds the step's global outputs to the registry
            # and the dump (its train/trainer.py:1221-1228, 1234-1245); over
            # several processes those arrays span devices no one process
            # can address, so it cannot run either
            raise NotImplementedError(
                "a metric registry or a dump over several hosts reads the global batch's outputs, "
                "which the JAX trainer cannot fetch over several processes: ROADMAP Queue 4 item 2"
            )
        dataset.mesh_plan = self.plan
        self._digest_ws = dataset.ws

    def train_pass(
        self,
        dataset: BoxPSDataset,
        n_batches: Optional[int] = None,
        on_batch: Optional[Callable[[int, Dict], None]] = None,
        profile: bool = False,
    ) -> Dict[str, float]:
        """Train ``n_batches`` minibatches of the current pass (all of them
        by default; the flat feeds wrap around past the tail, the join
        phase's stop at its last pv batch); returns pass metrics. In test
        mode (the trainer's, or its ``box``'s) it evaluates them instead.

        Call between ``dataset.begin_pass()`` and ``dataset.end_pass(...)``.
        ``profile=True`` adds ``out["profile"]``, host seconds in
        ``feed_wait_s`` (prepare, pack or build not hidden by overlap),
        ``step_dispatch_s`` (handing work to the device),
        ``device_step_s`` (waiting for it: every batch waits, one batch a
        dispatch) and ``host_metrics_s`` (the per-batch consumers); the
        slow feed adds ``build_batch_s``, ``pack_batch_s`` and ``h2d_s``."""
        if dataset.device_table is None:
            raise RuntimeError("dataset.begin_pass() first")
        # the join phase serves pv-merged batches with rank_offset and ghost
        # weights, the update phase flat ones (data_feed.cc:2165-2198)
        use_pv = dataset.pv_merged and dataset.current_phase == 1
        with PROFILER.record_event("train_pass.open", "pass"):
            self._check_replicas(dataset)
            self._multi_pass = self._multi(dataset)
            state = self._make_state(dataset.device_table, ws_key=dataset.ws)
            tm = dict.fromkeys(_PROFILE_KEYS, 0.0)
            # AUC buckets accumulate across train_pass calls within one pass:
            # this call reports the delta (on a mesh, of the ranks' sum)
            auc0 = self._auc_host(state.auc)
            losses: list = []
            skip_flags: list = []
            holder = {"state": state}
            eval_mode = self._eval_active
            is_async = self.cfg.dense_sync_mode == "async" and not eval_mode
            if is_async and self._lead and set(self.async_dense.pull_dense()) != set(state.params):
                raise ValueError("the AsyncDenseTable's params are not the model's")
            step_fn = self._step_fn(eval_mode)
            if self._use_resident(dataset, use_pv, is_async):
                feed = "resident_pv" if use_pv else "resident"
                stepper = self._resident_stepper(dataset, n_batches, holder, eval_mode, profile, tm, use_pv)
            else:
                if use_pv and dataset.store is not None:
                    feed = "pv_packer"
                    it = self._pv_plan_feed_iter(dataset, self._pv_locked_plan(dataset), n_batches)
                elif use_pv:
                    feed = "pv_records"
                    it = self._pv_feed_iter(dataset, n_batches)
                elif dataset.store is not None:
                    feed = "packer"
                    it = self._fast_feed_iter(dataset, n_batches)
                else:
                    feed = "slow"
                    tm.update(dict.fromkeys(_SLOW_FEED_KEYS, 0.0))
                    it = self._slow_feed_iter(dataset, n_batches, profile, tm)
                stepper = self._classic_stepper(it, holder, step_fn, profile, tm, is_async)
            self.last_feed = feed
        try:
            for i, m, aux in stepper:
                t0 = time.perf_counter()
                self._consume_batch(i, m, aux, dataset, on_batch, losses, skip_flags)
                tm["host_metrics_s"] += time.perf_counter() - t0
        except BaseException:
            # the table was updated in place up to the failing step; keep
            # the last returned state so a retry sees what was trained
            self._state = holder["state"]
            raise
        with PROFILER.record_event("train_pass.close", "pass"):
            state = holder["state"]
            if is_async:
                # the host table owns the dense params: take its latest view
                self.params = self._async_params(state.params)
                self.opt_state = state.opt_state  # untouched in async mode
            elif self.plan is None:
                # an eval pass returns params and optimizer state as they came
                self.params, self.opt_state = state.params, state.opt_state
            else:
                state = self._mesh_pass_end(state, eval_mode)
            self._state = state
            if self.dump_pool is not None and self.dump_params_at_end and self._lead:
                self._dump_params()

            cum = self._auc_host(state.auc)
            with PROFILER.record_event("auc_compute", "pass"):
                out = auc_compute(AucState(pos=cum.pos - auc0.pos, neg=cum.neg - auc0.neg))
            with PROFILER.record_event("auc_compute", "pass"):
                cum_out = auc_compute(cum)
            out["auc_cumulative"] = cum_out["auc"]
            out["saturated"] = cum_out["saturated"]
            if losses and skip_flags:
                with PROFILER.record_event("sync.losses", "sync"):
                    lv = torch.stack(losses).cpu()
                with PROFILER.record_event("sync.nan_flags", "sync"):
                    bad = torch.stack(skip_flags).cpu() > 0
                kept = max(int((~bad).sum()), 1)
                out["loss"] = float(torch.where(bad, 0.0, lv).sum()) / kept
                out["nan_batches"] = float(bad.sum())
            else:
                out["loss"] = float("nan")
                if losses:
                    with PROFILER.record_event("sync.losses", "sync"):
                        out["loss"] = float(torch.stack(losses).mean())
                out["nan_batches"] = 0.0
        out["batches"] = float(len(losses))
        if profile:
            out["profile"] = tm
        return out

    @property
    def _lead(self) -> bool:
        """The one device, or rank 0 of a mesh: the process that holds the
        async dense table and writes the dump (each line once)."""
        return self.plan is None or self.plan.rank == 0

    def _async_params(self, like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The async dense table's params on the device, copies (PullDense).
        On a mesh rank 0 pulls and one broadcast of the flattened params
        puts its bits on every rank (the other ranks' buffers give only the
        shapes)."""
        if self.plan is None:
            return {k: torch.from_numpy(v).to(self.device, copy=True) for k, v in self.async_dense.pull_dense().items()}
        keys = list(like)
        if self._lead:
            host = self.async_dense.pull_dense()
            flat = torch.cat([torch.from_numpy(np.asarray(host[k], np.float32)).reshape(-1) for k in keys])
            flat = flat.to(self.device)
        else:
            flat = torch.empty(sum(like[k].numel() for k in keys), dtype=torch.float32, device=self.device)
        flat = self.plan.broadcast(flat, src=0)
        out, off = {}, 0
        for k in keys:
            n = like[k].numel()
            out[k] = flat[off : off + n].reshape(like[k].shape)
            off += n
        return out

    def _gather_instances(self, m: Dict) -> Dict:
        """``m`` with each per-instance output ([b, ...] float32: ``preds``,
        ``labels``) replaced by every rank's, [world, b, ...] in rank order
        (the JAX mesh step's layout), in ONE all-gather."""
        b = self.cfg.batch_size
        names = [
            k for k, v in m.items()
            if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == b and v.dtype == torch.float32
        ]
        if not names:
            return m
        parts = [m[k].reshape(-1) for k in names]
        every = self.plan.all_gather(torch.cat(parts))  # [world, sum]
        out, off = dict(m), 0
        for k, p in zip(names, parts):
            out[k] = every[:, off : off + p.numel()].reshape(self.plan.world, *m[k].shape)
            off += p.numel()
        return out

    def _auc_host(self, auc: AucState) -> AucState:
        """The AUC bucket tables on the host: the ranks' sum on a mesh."""
        if self.plan is not None:
            auc = auc_psum(auc, self.plan)
        with PROFILER.record_event("sync.auc_tables", "sync"):
            pos = auc.pos.cpu().clone()
        with PROFILER.record_event("sync.auc_tables", "sync"):
            neg = auc.neg.cpu().clone()
        return AucState(pos=pos, neg=neg)

    def _mesh_pass_end(self, state: TrainState, eval_mode: bool) -> TrainState:
        """The dense side of a mesh pass, kept for the next pass. kstep
        averages the replicas (the pass-end SyncParam) and keeps rank 0's
        optimizer state on every rank (the JAX package keeps device 0's);
        an eval pass skips the average, whose sum would move bits. ZeRO-1's
        chunk states are all-gathered into the stacked state."""
        plan = self.plan
        if isinstance(self.dense_opt, Zero1Optimizer):
            self.params = state.params
            self.opt_state = tree_map(plan.all_gather, state.opt_state)
            return state
        if self.cfg.dense_sync_mode == "kstep" and not eval_mode:
            state = kstep_sync_params(state, plan)
            self.opt_state = tree_map(lambda t: plan.all_gather(t)[0], state.opt_state)
        else:
            self.opt_state = state.opt_state
        self.params = state.params
        return state

    def _consume_batch(self, i, m, aux, dataset: BoxPSDataset, on_batch, losses, skip_flags) -> None:
        """Host-side per-batch consumers, shared by every stepper. A batch
        the NaN check skipped reaches neither the async dense table, the
        registry nor the dump (the read of its flag waits for the device,
        and happens only with such a consumer, which reads the batch back
        anyway; on a mesh the flag is all-reduced, so every rank skips
        alike). On a mesh the registry and the dump read the global
        batch's outputs (:meth:`_gather_instances`)."""
        if "nan_skipped" in m:
            skip_flags.append(m["nan_skipped"])
        reg = self.metric_registry
        is_async = "gparams" in m  # an async training step's
        skipped = 0
        if "nan_skipped" in m and (is_async or reg is not None or self.dump_pool is not None):
            with PROFILER.record_event("sync.nan_flags", "sync"):
                skipped = int(m["nan_skipped"])
        if is_async and not skipped and self._lead:
            self.async_dense.push_dense(m["gparams"])  # PushDense
        if self.plan is not None and not skipped and (reg is not None or self.dump_pool is not None):
            m = self._gather_instances(m)
        if reg is not None and not skipped:
            # per-batch registry feed with the phase and the logkey inputs
            # (AddAucMonitor parity, boxps_worker.cc:408-418)
            reg.add_all({**m, **aux}, phase=dataset.current_phase)
        if self.dump_pool is not None and not skipped and self._lead:
            self._dump_batch(i, m, aux)
        if on_batch is not None:
            on_batch(i, m)
        losses.append(m["loss"])

    def _dump_batch(self, step_i: int, m: Dict, aux: Dict) -> None:
        """Per-batch field dump (DeviceWorker::DumpField): every field of
        ``dump_fields_list`` the step returned per instance, one line an
        instance, sampled by ``dump_mode``."""
        if not self.dump_pool._started:
            self.dump_pool.start()
        fields = {}
        n_ins = None
        for name in self.dump_fields_list:
            v = m.get(name)
            if not isinstance(v, torch.Tensor) or v.dim() == 0:
                continue  # scalars (loss, step) have no rows an instance
            arr = v.detach().cpu().numpy()
            flat = arr.reshape(-1, *arr.shape[2:]) if arr.ndim > 1 else arr
            fields[name] = flat
            n_ins = len(flat) if n_ins is None else min(n_ins, len(flat))
        if not fields or not n_ins:
            return
        ins_ids = aux.get("ins_ids")
        if ins_ids is None or len(ins_ids) != n_ins:
            ins_ids = [f"b{step_i}:{j}" for j in range(n_ins)]  # no parsed ids: batch ordinals
        dump_fields(
            self.dump_pool, ins_ids, {k: v[:n_ins] for k, v in fields.items()}, step=step_i,
            dump_mode=self.dump_mode, dump_interval=self.dump_interval,
        )

    def _dump_params(self) -> None:
        """DumpParam (device_worker.cc:131-133): the dense params once, one
        line a leaf, under the JAX package's leaf paths and layouts."""
        from paddlebox_tpu_torch.models.convert import jax_named_leaves

        for name, leaf in jax_named_leaves(self.params):
            dump_param(self.dump_pool, name, leaf)

    def trained_table(self) -> np.ndarray:
        """The pass's trained table on the host, [rows, width], for
        ``dataset.end_pass``; on a mesh every rank's shard, all-gathered
        into [world, cap, width] on every rank; over several hosts this
        rank's block [1, cap, width], nothing gathered (its end_pass writes
        it into this host's own table)."""
        if self._state is None:
            raise RuntimeError("no trained pass")
        if self._multi_pass:
            # this host's block: its end_pass writes it into its own table
            return self._state.table.to("cpu", copy=True).numpy()[None]
        if self.plan is not None:
            return self.plan.all_gather(self._state.table).cpu().numpy()
        return self._state.table.to("cpu", copy=True).numpy()

    def trained_table_device(self) -> torch.Tensor:
        """The live trained table on the device, [rows, width], no copy.
        Handed to ``dataset.end_pass`` it opts into the carried boundary
        (``table/carrier.py``): the next begin_pass splices the rows that
        stay on the device and fetches only the departing ones. The
        trainer never writes it again: the next pass trains a copy. On a
        mesh it is this rank's shard [cap, width]: its end_pass carries the
        shard, the departing rows all-gathered to every rank's host
        table (over several hosts, in a ``MultiHostCarrier``: the departing
        rows go to this host's own table, nothing gathered)."""
        if self._state is None:
            raise RuntimeError("no trained pass")
        return self._state.table

    def handoff_table(self, dataset: BoxPSDataset) -> None:
        """Carry this trainer's trained table into another trainer's
        train_pass over the same working set, on the device: a two-phase
        pass trains with two trainers (each binds one step config), and
        the second must start from the first one's rows, not the
        pass-open table::

            join_tr.train_pass(ds); join_tr.handoff_table(ds)
            upd_tr.train_pass(ds);  ds.end_pass(upd_tr.trained_table())
        """
        if self._state is None:
            raise RuntimeError("no trained pass")
        t = self._state.table
        if self._multi_pass:
            t = t[None]  # this host's block, on the device
        elif self.plan is not None:  # every rank's shard, so each rank picks its own
            t = self.plan.all_gather(t)
        dataset.device_table = t.reshape(-1, dataset.ws.capacity, t.shape[-1])
