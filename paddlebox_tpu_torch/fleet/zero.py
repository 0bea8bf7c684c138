"""ZeRO-1: the dense optimizer's state sharded over the mesh.

Port of the JAX package's ``fleet/zero.py`` (fleet v2's sharding
meta-optimizer, meta_optimizers/sharding_optimizer.py): the dense params
stay replicated, the Adam moments are split 1/n over the ranks. Each rank
updates its chunk of the parameter vector and an ``all_gather`` rebuilds
the whole update.

The params ravel into one flat vector in the JAX package's order: its
params tree flattened (dict keys sorted, lists by index) with each leaf
in its layout (an ``nn.Linear`` weight as [in, out]), the order
``models/convert.py`` spells out; then zero-padded to n equal chunks
[n, c]. So chunk ``r`` of a port state is chunk ``r`` of a JAX state, and
a ZeRO state converts across packages. Adam is elementwise, so the
chunked update is the unchunked one.

The inner optimizer is the port's :class:`Adam`, or a
:class:`MultiSteps` around it (the strategy's ``gradient_merge`` with
``sharding``: JAX's ``Zero1Optimizer(optax.MultiSteps(adam, k))``). The
state of a rank is the inner optimizer's state over one tensor,
``"flat"`` [c], its chunk (an ``AdamState`` whose moments hold it, and for
``MultiSteps`` also its ``acc_grads``); ``init_stacked`` builds all n,
every leaf with a leading [n] axis ([n] counts, [n, c] moments), as the
JAX package's ``vmap`` of the inner ``init`` does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.train.dense_opt import tree_leaves, tree_map

Params = Dict[str, torch.Tensor]


def _jax_key(name: str) -> tuple:
    """Sort key of a port param name in the JAX tree-flatten order: the
    JAX path's parts, list indices as ints (siblings are all keys or all
    indices)."""
    from paddlebox_tpu_torch.models.convert import jax_path

    return tuple(int(p) if p.isdigit() else p for p in jax_path(name).split("/"))


def jax_order(params: Params) -> List[str]:
    """The port's param names in the order JAX ravels its params tree."""
    return sorted(params, key=_jax_key)


def _jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf in the JAX package's layout: an ``nn.Linear`` weight
    transposed to [in, out], every other leaf as it is."""
    return t.t() if name.endswith("weight") and t.dim() == 2 else t


def ravel(params: Params) -> torch.Tensor:
    """The params as one flat f32 vector in JAX's ravel order."""
    return torch.cat([_jax_layout(k, params[k]).reshape(-1) for k in jax_order(params)])


def unravel(flat: torch.Tensor, like: Params) -> Params:
    """The inverse of :func:`ravel`, shaped like ``like``."""
    out, off = {}, 0
    for k in jax_order(like):
        t = _jax_layout(k, like[k])
        n = t.numel()
        out[k] = _jax_layout(k, flat[off : off + n].reshape(t.shape)).contiguous()
        off += n
    return {k: out[k] for k in like}


class Zero1Optimizer:
    """Chunked wrapper over the port's elementwise :class:`Adam` (or a
    :class:`MultiSteps` of it)."""

    def __init__(self, inner: Any, axis_name: str = "dp", n_dev: int = 1):
        self.inner = inner
        self.axis_name = axis_name
        self.n_dev = n_dev

    # Not the optimizer interface: picking a chunk needs the mesh, so this
    # optimizer runs only inside the sharded or the pipeline step.
    def init(self, params):
        raise RuntimeError(
            "Zero1Optimizer state is mesh-sharded: it runs inside "
            "make_sharded_train_step (state from init_sharded_train_state) "
            "or make_pipeline_train_step with dp_axis (state from "
            "init_pipeline_state). For one device use the inner optimizer."
        )

    def update(self, grads, state):
        self.init(grads)  # same message

    def check_axis(self, axis_name: str, n_axis: int) -> None:
        """Validate this optimizer against the mesh axis it chunks over."""
        if self.axis_name != axis_name:
            raise ValueError(
                f"Zero1Optimizer chunks over axis {self.axis_name!r}, step/state "
                f"built for axis {axis_name!r}"
            )
        if self.n_dev != n_axis:
            raise ValueError(
                f"Zero1Optimizer built for {self.n_dev} devices, axis {axis_name!r} has {n_axis}"
            )

    def _chunks(self, params: Params) -> Tuple[torch.Tensor, int]:
        """ravel -> pad -> [n_dev, c]; returns (chunks, true length)."""
        flat = ravel(params)
        n = flat.shape[0]
        c = -(-n // self.n_dev)
        return F.pad(flat, (0, c * self.n_dev - n)).reshape(self.n_dev, c), n

    def init_stacked(self, params: Params) -> Any:
        """Every chunk's state, stacked: each leaf [n_dev, ...] (count
        [n_dev], moments [n_dev, c])."""
        chunks, _ = self._chunks(params)
        per_chunk = [self.inner.init({"flat": chunks[r]}) for r in range(self.n_dev)]
        return tree_map(lambda *xs: torch.stack(xs), *per_chunk)

    @staticmethod
    def local_state(stacked: Any, rank: int) -> Any:
        """Chunk ``rank``'s state of a stacked one."""
        return tree_map(lambda t: t[rank].clone(), stacked)

    @staticmethod
    def is_stacked(state: Any) -> bool:
        """A stacked state (every chunk's) rather than one rank's: its
        leading scalar leaf carries the [n_dev] axis."""
        return tree_leaves(state)[0].dim() == 1

    def update_local(self, plan, grads: Params, state_local: Any) -> Tuple[Params, Any]:
        """(the whole update, this rank's new chunk state). ``grads`` are
        the mesh's reduced grads, the same on every rank."""
        gchunks, n = self._chunks(grads)
        upd, new_state = self.inner.update({"flat": gchunks[plan.rank]}, state_local)
        whole = plan.all_gather(upd["flat"]).reshape(-1)[:n]
        return unravel(whole, grads), new_state
