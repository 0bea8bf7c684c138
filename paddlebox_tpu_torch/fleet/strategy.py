"""DistributedStrategy: one config object that picks the execution strategy.

Port of the JAX package's ``fleet/strategy.py`` (fleet v2's proto-backed
strategy, distributed_strategy.py:101-829). Each reference flag maps onto
one of the port's mechanisms:

| reference flag            | here                                          |
|---------------------------|-----------------------------------------------|
| a_sync                    | dense_sync_mode="async" (host AsyncDenseTable)|
| a_sync_configs.k_steps>0  | dense_sync_mode="kstep" + param_sync_step     |
| localsgd(+k_steps)        | dense_sync_mode="kstep" + param_sync_step     |
| sharding (ZeRO)           | Zero1Optimizer wrap of the dense optimizer    |
| recompute                 | torch.utils.checkpoint around model apply     |
| amp                       | the dense model computed in bf16              |
| pipeline(+micro_batch)    | PipelineSpec over a 'pp' axis (pipeline_spec) |
| gradient_merge(+k_steps)  | MultiSteps accumulation (train/dense_opt.py)  |

``apply()`` folds the flags into a TrainStepConfig, an optimizer and a
model apply function. ``pipeline`` selects another step builder
(``parallel/pipeline.py``): ``apply()`` refuses it with a ``ValueError``,
as the JAX package's does, and ``pipeline_spec()`` gives its
``PipelineSpec``; with ``pipeline_configs['dp_degree'] > 1`` the stages
repeat over a dp axis (``make_mesh_2d``), and ``sharding`` then means a
``Zero1Optimizer`` over that axis, handed to ``make_pipeline_train_step``.
``recompute`` is the counterpart of
``jax.checkpoint``: the forward's activations are recomputed in the
backward (``use_reentrant=False``), which gives the same gradients.
``amp`` is the JAX package's ``bf16_apply``: every fp32 tensor of the
params and the arguments is cast to bf16, the model runs on those, and
its outputs come back as fp32. ``gradient_merge`` wraps the dense
optimizer in :class:`~paddlebox_tpu_torch.train.dense_opt.MultiSteps`
(``optax.MultiSteps``), inside ZeRO-1's chunking when ``sharding`` is
set too, as the JAX package nests them.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from paddlebox_tpu_torch.train.dense_opt import Adam, MultiSteps, tree_map

def _bf16(t: Any) -> Any:
    """An fp32 tensor as bf16; anything else as it is."""
    return t.to(torch.bfloat16) if isinstance(t, torch.Tensor) and t.dtype == torch.float32 else t


def _fp32(t: Any) -> Any:
    return t.to(torch.float32) if isinstance(t, torch.Tensor) else t


def recompute_apply(model_apply: Callable) -> Callable:
    """``model_apply`` whose activations are recomputed in the backward
    (``jax.checkpoint``'s counterpart)."""

    def apply(params, *args, **kw):
        return checkpoint(model_apply, params, *args, use_reentrant=False, **kw)

    return apply


def bf16_apply(model_apply: Callable) -> Callable:
    """``model_apply`` computed in bf16: the fp32 params and arguments cast
    to bf16, the outputs cast back to fp32 (the JAX package's
    ``bf16_apply``)."""

    def apply(params, *args, **kw):
        out = model_apply(tree_map(_bf16, params), *[tree_map(_bf16, a) for a in args], **kw)
        return tree_map(_fp32, out)

    return apply


@dataclass
class DistributedStrategy:
    # async PS (a_sync, distributed_strategy.py:239-320)
    a_sync: bool = False
    a_sync_configs: Dict[str, Any] = field(default_factory=dict)  # {"k_steps": int}
    # LocalSGD (distributed_strategy.py:778-829)
    localsgd: bool = False
    localsgd_configs: Dict[str, Any] = field(default_factory=lambda: {"k_steps": 16})
    # ZeRO-style sharding (distributed_strategy.py:658-708)
    sharding: bool = False
    sharding_configs: Dict[str, Any] = field(default_factory=dict)
    # recompute / amp (distributed_strategy.py:322-652)
    recompute: bool = False
    amp: bool = False
    # pipeline (distributed_strategy.py:714-734)
    pipeline: bool = False
    pipeline_configs: Dict[str, Any] = field(default_factory=lambda: {"micro_batch": 4})
    # gradient merge (accumulation)
    gradient_merge: bool = False
    gradient_merge_configs: Dict[str, Any] = field(default_factory=lambda: {"k_steps": 4})

    def __post_init__(self):
        if self.a_sync and self.localsgd:
            raise ValueError("a_sync and localsgd are mutually exclusive")
        if self.pipeline and (self.a_sync or self.localsgd):
            raise ValueError(
                "pipeline composes with neither a_sync nor localsgd: pipeline "
                "stages own their params, there is no DP dense sync to reconfigure"
            )
        if self.pipeline and self.sharding and self.pipeline_dp_degree < 2:
            raise ValueError(
                "pipeline + sharding needs a dp axis to chunk over: set "
                "pipeline_configs['dp_degree'] > 1"
            )

    # ---- translation ----------------------------------------------------

    @property
    def dense_sync_mode(self) -> str:
        """The TrainStepConfig dense mode the flags select: a_sync with
        k_steps 0 is async, with k_steps > 0 k-step sync
        (distributed_strategy.py:274-316); localsgd is k-step."""
        if self.a_sync:
            return "kstep" if self.a_sync_configs.get("k_steps", 0) > 0 else "async"
        if self.localsgd:
            return "kstep"
        return "step"

    @property
    def k_steps(self) -> int:
        if self.a_sync:
            return max(1, self.a_sync_configs.get("k_steps", 0))
        return max(1, self.localsgd_configs.get("k_steps", 16))

    @property
    def pipeline_dp_degree(self) -> int:
        """Data-parallel replicas a pipeline stage (1 = pure pipeline)."""
        return int(self.pipeline_configs.get("dp_degree", 1))

    def apply(
        self,
        cfg: "TrainStepConfig",
        dense_opt: Adam,
        model_apply=None,
        n_dev: int = 1,
        axis_name: str = "dp",
    ) -> Tuple["TrainStepConfig", Any, Any]:
        """Fold the strategy into (cfg, optimizer, model_apply).
        ``recompute`` and ``amp`` wrap ``model_apply`` when one is given
        (``recompute`` inside ``amp``, as the JAX package nests them).
        ``pipeline`` does not fold into a TrainStepConfig: take
        ``pipeline_spec()`` to ``make_pipeline_train_step`` instead."""
        if self.pipeline:
            raise ValueError(
                "pipeline=True selects a different step builder: use "
                "strategy.pipeline_spec() with "
                "paddlebox_tpu_torch.parallel.make_pipeline_train_step"
            )
        cfg = replace(cfg, dense_sync_mode=self.dense_sync_mode, param_sync_step=self.k_steps)
        if self.gradient_merge:
            dense_opt = MultiSteps(dense_opt, self.gradient_merge_configs.get("k_steps", 4))
        if self.sharding:
            from paddlebox_tpu_torch.fleet.zero import Zero1Optimizer

            dense_opt = Zero1Optimizer(dense_opt, axis_name=axis_name, n_dev=n_dev)
        if model_apply is not None and self.recompute:
            model_apply = recompute_apply(model_apply)
        if model_apply is not None and self.amp:
            model_apply = bf16_apply(model_apply)
        return cfg, dense_opt, model_apply

    def pipeline_spec(self, axis_name: str = "pp"):
        """The ``PipelineSpec`` of ``pipeline_configs``, for
        ``make_pipeline_train_step``. ``pipeline_configs['dp_degree'] > 1``
        selects pipeline x data: build the plan with ``make_mesh_2d(n_pp,
        dp_degree)`` and pass ``dp_axis='dp'`` to the step builder."""
        from paddlebox_tpu_torch.parallel.pipeline import PipelineSpec

        if not self.pipeline:
            raise ValueError("strategy.pipeline is False")
        return PipelineSpec(n_micro=self.pipeline_configs.get("micro_batch", 4), axis_name=axis_name)
