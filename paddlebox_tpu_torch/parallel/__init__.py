"""The distributed tier: the process-group mesh and the sharded sparse
pull/push over it.

Port of the JAX package's ``parallel`` package: a
``torch.distributed`` process group (one rank a card) and its
``all_to_all`` / ``all_reduce`` / ``all_gather`` stand in for the JAX
mesh's XLA collectives; the pass table is sharded over the ranks. The host
plane over several hosts is ``transport`` (``TcpTransport``,
``TcpShuffleRouter``) and ``membership`` (``OwnershipMap``). ``pipeline``
is the GPipe schedule over a ``pp`` axis (``make_mesh(..., axis="pp")``,
or ``make_mesh_2d`` for pipeline x data). ``ring_attention`` is sequence
parallelism: ring attention (the (k, v) blocks rotate by
``MeshPlan.shift``) and Ulysses attention (two tiled all_to_alls around
exact local attention) over a sequence sharded on one axis, with their
gradients.
"""

from paddlebox_tpu_torch.parallel.mesh import (
    MeshPlan,
    axis_size,
    destroy_mesh,
    local_slice,
    make_mesh,
    make_mesh_2d,
    put_axis1_blocks,
    put_per_device_copies,
    put_replicated,
    put_sharded,
)
from paddlebox_tpu_torch.parallel.pipeline import (
    PipelineSpec,
    hetero_mlp_stage_apply,
    hetero_mlp_stage_init,
    init_pipeline_state,
    make_pipeline_train_step,
    pipeline_forward,
)
from paddlebox_tpu_torch.parallel.ring_attention import ring_attention, ulysses_attention
from paddlebox_tpu_torch.parallel.sharded_pullpush import sharded_pull, sharded_push, sharded_serve_pull

__all__ = [
    "MeshPlan",
    "axis_size",
    "destroy_mesh",
    "local_slice",
    "make_mesh",
    "make_mesh_2d",
    "put_axis1_blocks",
    "put_per_device_copies",
    "put_replicated",
    "put_sharded",
    "sharded_pull",
    "sharded_push",
    "sharded_serve_pull",
    "PipelineSpec",
    "hetero_mlp_stage_apply",
    "hetero_mlp_stage_init",
    "pipeline_forward",
    "make_pipeline_train_step",
    "init_pipeline_state",
    "ring_attention",
    "ulysses_attention",
]
