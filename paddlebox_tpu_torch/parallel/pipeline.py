"""Pipeline parallelism: the GPipe microbatch schedule over a ``pp`` axis.

Port of the JAX package's ``parallel/pipeline.py`` (the reference's
PipelineTrainer + SectionWorker: each program section on its own device,
activations hopping by send_v2 / recv_v2, all microbatch forwards, then
all backwards, then one optimize pass). The JAX module compiles the
schedule into one ``shard_map``'d program; the port runs it SPMD, one
process a stage (a rank of the plan's ``pp`` axis), with the same ticks:

- rank ``p`` of the ``pp`` axis holds stage ``p``'s params;
- ``T = n_micro + n_stages - 1`` ticks: at tick ``t`` stage 0 takes
  microbatch ``t`` (while ``t < n_micro``), every other stage the buffer
  the previous stage shifted to it; every stage applies its params (under
  ``torch.utils.checkpoint`` when ``remat``); the last stage emits
  microbatch ``t - (n - 1)``; then the output hops to the next stage
  (:meth:`~paddlebox_tpu_torch.parallel.mesh.MeshPlan.shift`, the cyclic
  ``lax.ppermute``). The last tick's hop is dropped: the JAX scan
  discards that carry;
- the backward is autograd through the ticks and the shifts, whose
  backward sends each cotangent back a stage: the F-then-B schedule.

Every rank must run the same shifts in the same order, forward and
backward. So the schedule keeps the JAX package's masked dataflow: which
rank feeds a microbatch or emits an output is a ``torch.where`` on a
rank flag, never a Python branch on the rank, and every tick's shift is
in every rank's graph. A branch on the rank would leave a shift out of
one rank's graph; its backward would never run there and its peers would
wait for it until the group's timeout.

Stage contract: every stage maps [mb, H] -> [mb, H] at the hop (the
shift moves tensors of one shape), but stages need not be uniform inside:
:func:`hetero_mlp_stage_init` pads any per-stage layer counts and widths
to [L, H, H] with zero padding and identity gates, exactly the unpadded
network.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from paddlebox_tpu_torch.parallel.mesh import MeshPlan, _as_tensor

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class PipelineSpec:
    n_micro: int  # microbatches a global batch (num_microbatches_ parity)
    axis_name: str = "pp"
    remat: bool = True  # re-run the stage's forward in the backward


def _flag(value: bool, device: torch.device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.bool, device=device)


def pipeline_forward(stage_apply: Callable, spec: PipelineSpec, broadcast: bool = True) -> Callable:
    """Build ``fn(plan, stage_params, x_micro) -> y_micro``, run on every
    rank of the plan (``spec.axis_name`` is one of its axes).

    ``x_micro`` [n_micro, mb, H] is read by stage 0 only. With
    ``broadcast`` the returned ``y_micro`` [n_micro, mb, H] holds the last
    stage's outputs on every rank (a sum over ``pp`` of outputs that are
    zero off the last stage), for inference; it carries no gradient. For
    training take ``broadcast=False``: the outputs stay zero off the last
    stage, and the loss is masked to the last stage."""
    apply = (lambda p, x: checkpoint(stage_apply, p, x, use_reentrant=False)) if spec.remat else stage_apply

    def fn(plan: MeshPlan, stage_params: Any, x_micro: torch.Tensor) -> torch.Tensor:
        pp = plan.along(spec.axis_name)
        n, m = pp.world, spec.n_micro
        if x_micro.shape[0] != m:
            raise ValueError(f"x_micro has {x_micro.shape[0]} microbatches, the spec {m}")
        first, last = _flag(pp.rank == 0, x_micro.device), _flag(pp.rank == n - 1, x_micro.device)
        buf = torch.zeros_like(x_micro[0])
        outs = []
        for t in range(m + n - 1):
            x_in = torch.where(first, x_micro[t], buf) if t < m else buf
            y = apply(stage_params, x_in)
            if t >= n - 1:  # the last stage emits microbatch t - (n - 1)
                outs.append(torch.where(last, y, 0.0))
            if t < m + n - 2:
                buf = pp.shift(y)
        y_micro = torch.stack(outs)
        if not broadcast:
            return y_micro
        with torch.no_grad():
            return pp.all_reduce(y_micro)

    return fn


def make_pipeline_train_step(
    stage_apply: Callable,  # (stage_params, x[mb, H]) -> y[mb, H]
    loss_fn: Callable,  # (y[mb, H], target[mb, ...]) -> 0-d mean loss
    dense_opt: Any,
    spec: PipelineSpec,
    plan: MeshPlan,
    dp_axis: Optional[str] = None,
) -> Callable:
    """``step((params, opt_state), x_micro, targets) -> ((params,
    opt_state), loss)`` on every rank of the plan.

    ``params`` / ``opt_state`` are this rank's stage's
    (:func:`init_pipeline_state`); ``x_micro`` [n_micro, mb, H] and
    ``targets`` [n_micro, mb, ...] are the global microbatches, the same on
    every rank (stage 0 reads ``x_micro``, the last stage ``targets``).
    The loss is the mean of the microbatches' losses, equal on every rank.
    The step returns a new state and leaves the one passed in as it was
    (the JAX step donates its state instead).

    ``dp_axis``: pipeline x data on a :func:`make_mesh_2d` plan. Each
    pipeline replica trains its dp block of every microbatch (``mb`` split
    over dp, which must divide it), and a stage's grads and the loss are
    averaged over dp before the local update.

    ``dense_opt`` is the port's ``Adam`` (or another optimizer with its
    ``init`` / ``update``), or a ``Zero1Optimizer`` over ``dp_axis``: each
    dp replica of a stage then holds 1/n_dp of the stage's moments,
    updates its chunk and all-gathers the whole update over dp."""
    from paddlebox_tpu_torch.fleet.zero import Zero1Optimizer

    if spec.axis_name not in plan.axis_names:
        raise ValueError(
            f"PipelineSpec.axis_name {spec.axis_name!r} not a mesh axis {plan.axis_names}; "
            f"build the mesh with make_mesh(..., axis={spec.axis_name!r})"
        )
    if dp_axis is not None and dp_axis not in plan.axis_names:
        raise ValueError(
            f"dp_axis {dp_axis!r} not a mesh axis {plan.axis_names}; build a 2-D mesh with make_mesh_2d(n_pp, n_dp)"
        )
    is_zero = isinstance(dense_opt, Zero1Optimizer)
    if is_zero:
        if dp_axis is None:
            raise ValueError("pipeline ZeRO-1 shards optimizer state over the dp axis: pass dp_axis= on a pp x dp mesh")
        dense_opt.check_axis(dp_axis, plan.along(dp_axis).world)
    pp = plan.along(spec.axis_name)
    dp = plan.along(dp_axis) if dp_axis is not None else None
    fwd = pipeline_forward(stage_apply, spec, broadcast=False)

    def step(state: Tuple[Params, Any], x_micro: Any, targets: Any) -> Tuple[Tuple[Params, Any], torch.Tensor]:
        params, opt_state = state
        x_micro, targets = _as_tensor(x_micro), _as_tensor(targets)
        if dp is not None:
            mb = x_micro.shape[1]
            if mb % dp.world:
                raise ValueError(f"a microbatch of {mb} does not split over {dp.world} dp replicas")
            c = mb // dp.world
            x_micro, targets = (t[:, dp.rank * c : (dp.rank + 1) * c] for t in (x_micro, targets))
        x_micro, targets = x_micro.to(pp.device), targets.to(pp.device)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        y = fwd(plan, p, x_micro)  # [M, mb, H], zeros off the last stage
        per_mb = torch.stack([loss_fn(y[i], targets[i]) for i in range(spec.n_micro)])
        # only the last stage's loss seeds a cotangent; the others get
        # their grads through the shifts' backward
        loss_local = torch.where(_flag(pp.rank == pp.world - 1, y.device), per_mb.mean(), 0.0)
        got = torch.autograd.grad(loss_local, list(p.values()), allow_unused=True)
        # a param outside the graph (the hetero stages' detached gate) gets
        # a zero grad, as JAX's stop_gradient gives it
        grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(p.items(), got)}
        with torch.no_grad():
            loss = pp.all_reduce(loss_local.detach())
            if dp is not None:
                flat = dp.all_reduce(torch.cat([g.reshape(-1) for g in grads.values()] + [loss.reshape(1)]))
                flat = flat / dp.world
                grads, off = {}, 0
                for k, v in p.items():
                    grads[k] = flat[off : off + v.numel()].reshape(v.shape)
                    off += v.numel()
                loss = flat[off]
            if is_zero:
                updates, new_opt = dense_opt.update_local(dp, grads, opt_state)
            else:
                updates, new_opt = dense_opt.update(grads, opt_state)
            new_p = {k: params[k] + updates[k] for k in params}
        return (new_p, new_opt), loss

    return step


def init_pipeline_state(
    plan: MeshPlan,
    stage_params: Sequence[Any],  # one dict a stage, identical structure
    dense_opt: Any,
    axis: Optional[str] = None,
    dp_axis: Optional[str] = None,
) -> Tuple[Params, Any]:
    """This rank's ``(params, opt_state)``: its stage's params on the
    plan's device and their optimizer state.

    ``axis`` names the pipeline axis and defaults to the plan's (a 1-D
    ``make_mesh(..., axis="pp")``); on a :func:`make_mesh_2d` plan pass
    ``axis="pp"``: the stages spread over it and repeat over dp. With a
    ``Zero1Optimizer`` (``dp_axis`` too) the state is this rank's dp chunk
    of its stage's state."""
    from paddlebox_tpu_torch.fleet.zero import Zero1Optimizer

    axis = axis or plan.axis
    pp = plan.along(axis)
    if len(stage_params) != pp.world:
        raise ValueError(f"{len(stage_params)} stages for a {pp.world}-stage {axis!r} axis")
    params = {k: _as_tensor(v).to(plan.device, copy=True) for k, v in stage_params[pp.rank].items()}
    if isinstance(dense_opt, Zero1Optimizer):
        if dp_axis is None:
            raise ValueError("Zero1Optimizer pipeline state needs dp_axis= (pp x dp mesh)")
        dp = plan.along(dp_axis)
        dense_opt.check_axis(dp_axis, dp.world)
        return params, Zero1Optimizer.local_state(dense_opt.init_stacked(params), dp.rank)
    return params, dense_opt.init(params)


# ---- heterogeneous stages by padded stacking ------------------------------
#
# The reference cuts one program at arbitrary points, so its stages have
# whatever shapes the cut gives. The shift wants one [mb, H] shape, so every
# stage is padded to the largest layer count L and width H:
#
#   * width padding is exact for matmul + bias + relu chains: padded weight
#     rows / columns and bias lanes are zero, so padded activation lanes stay
#     zero through the net and their cotangents die at the next stage's zero
#     weight rows; Adam sees zero grads and never moves the padding;
#   * layer-count padding uses a gate g in {0, 1} a layer (detached, carried
#     in the params but never trained): w_eff = g*w + (1-g)*I and
#     h' = g*relu(z) + (1-g)*z, so a g = 0 layer is an exact identity with
#     zero grads into its (w, b).


def hetero_mlp_stage_init(
    rng: torch.Generator, widths: Sequence[Sequence[int]]
) -> Tuple[List[Params], List[List[Tuple[np.ndarray, np.ndarray]]]]:
    """Stage params for a pipeline of different layer counts and widths.

    ``widths[s] = [d_0, ..., d_k]``: stage ``s`` maps width ``d_0`` to
    ``d_k`` through ``k`` relu layers; consecutive stages must chain
    (``widths[s][-1] == widths[s + 1][0]``). Weights are drawn layer by
    layer from ``rng`` as ``randn(d_in, d_out) / sqrt(d_in)``, so a network
    cut into other stages gets the same layers.

    Returns ``(stages, raw)``: ``stages`` are the padded ``{"w": [L, H, H],
    "b": [L, H], "g": [L]}`` dicts (one structure, for
    :func:`init_pipeline_state`); ``raw`` the unpadded ``(w [d_in, d_out],
    b [d_out])`` numpy layers, a sequential reference's."""
    for s in range(len(widths) - 1):
        if widths[s][-1] != widths[s + 1][0]:
            raise ValueError(
                f"stage {s} emits width {widths[s][-1]} but stage {s + 1} consumes {widths[s + 1][0]}"
            )
    H = max(max(w) for w in widths)
    L = max(len(w) - 1 for w in widths)
    stages, raw = [], []
    for ws in widths:
        w_pad = torch.zeros((L, H, H))
        b_pad = torch.zeros((L, H))
        gate = torch.zeros((L,))
        layers = []
        for l in range(len(ws) - 1):
            d_in, d_out = ws[l], ws[l + 1]
            w = torch.randn((d_in, d_out), generator=rng) / math.sqrt(d_in)
            w_pad[l, :d_in, :d_out] = w
            gate[l] = 1.0
            layers.append((w.numpy().copy(), np.zeros((d_out,), np.float32)))
        stages.append({"w": w_pad, "b": b_pad, "g": gate})
        raw.append(layers)
    return stages, raw


def hetero_mlp_stage_apply(stage_params: Params, x: torch.Tensor) -> torch.Tensor:
    """[mb, H] -> [mb, H] over the gated padded layers: an exact identity
    where g = 0, the relu MLP where g = 1."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    h = x
    for w, b, g in zip(stage_params["w"], stage_params["b"], stage_params["g"]):
        g = g.detach()  # the structural gate is never trained
        z = h @ (g * w + (1.0 - g) * eye) + g * b
        h = g * torch.relu(z) + (1.0 - g) * z
    return h


# ---- a homogeneous MLP stage for models and tests ---------------------------


def mlp_stage_init(rng: torch.Generator, hidden: int, layers_per_stage: int, n_stages: int) -> List[Params]:
    """Stage params for a uniform [mb, H] -> [mb, H] relu MLP pipeline."""
    out = []
    for _ in range(n_stages):
        ws = [torch.randn((hidden, hidden), generator=rng) * (1.0 / math.sqrt(hidden)) for _ in range(layers_per_stage)]
        out.append({"w": torch.stack(ws), "b": torch.zeros((layers_per_stage, hidden))})
    return out


def mlp_stage_apply(stage_params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w, b in zip(stage_params["w"], stage_params["b"]):
        h = torch.relu(h @ w + b)
    return h
