"""Carry the model zoo's weights and Adam state between the JAX package
and the port.

Every JAX model keeps a params tree of dicts and lists (DeepFM ``{"mlp":
[{"w": [in, out], "b": [out]}, ...], "out": {"w", "b"}, "b": scalar,
"dense_lin"?: ...}``, RankDeepFM ``{"base": <DeepFM>, "rank_param"}``,
LR ``{"b", "dense"?}``, Wide&Deep ``{"mlp", "out", "b",
"wide_dense"?}``, DCN ``{"cross_w": [...], "cross_b": [...], "mlp",
"out"}``, MMoE ``{"experts": [{"w": [E, in, out], "b": [E, out]}, ...],
"gates": [...], "towers": [{"mlp", "out"}, ...]}``). The port's
``state_dict`` names each leaf by its path, dots between the parts, with
one rule: a ``{"w", "b"}`` dict whose ``w`` is 2-D is an ``nn.Linear``,
``weight`` [out, in] (the transpose) and ``bias``; every other leaf keeps
its name and layout (MMoE's stacked experts, DCN's crosses, a scalar
``b``, ``rank_param``). Callers hand a pytree over as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.

Adam's moments follow the same map (optax keeps them in the params' tree;
the port keeps them keyed like the ``state_dict``). Each function has its
inverse, so weights and state can be carried across and compared back.

The dense checkpoint file (``CTRTrainer.save_dense``) holds the leaves of
the JAX package's ``(params, optax.adam state)`` tree as ``leaf_0`` ..
``leaf_{n-1}``; :func:`dense_leaf_names` spells that order out (a JAX
tree flatten sorts dict keys and walks lists by index), and
:func:`dense_to_jax_leaves` / :func:`dense_from_jax_leaves` carry the
port's params and :class:`AdamState` to and from it. A gradient-merging
trainer's state (``optax.MultiSteps(adam, k)``, the port's
``MultiStepsState``) flattens to ``mini_step``, ``gradient_step``, Adam's
leaves, then ``acc_grads``.

A JAX mesh state crosses too (``mesh_*``): the ``[n, cap, W]`` table to a
rank's block, kstep's stacked params and moments (a leading [n] replica
axis) to a rank's replica, and ZeRO-1's stacked chunk state (count [n],
moments [n, c] of the params raveled in the JAX order,
``fleet/zero.py``) to chunk [rank]. A ZeRO dense file holds the params,
then the stacked count, first and second moments; the port's stacked
state (``{"flat": [n, c]}`` moments) writes and reads it.

A JAX pipeline state (``parallel/pipeline.py``'s ``init_pipeline_state``)
stacks its stages: params and optax Adam's moments carry a leading
[n_pp] stage axis, and under ZeRO-1 the chunk state a leading
[n_pp, n_dp] (count [n_pp, n_dp], moments [n_pp, n_dp, c]).
:func:`pipeline_stage_from_jax` gives a rank its stage's (params, state),
or its (stage, chunk)'s; :func:`pipeline_state_to_jax` stacks every
rank's back.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.train.dense_opt import AdamState, MultiStepsState, tree_map


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _leaves_with_paths(tree: Any, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) of every leaf of a params tree, in the order a JAX tree
    flatten visits them: dict keys sorted, list items in order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaves_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _is_linear(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {"w", "b"} and np.ndim(node["w"]) == 2


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX zoo model's params (numpy leaves) -> the port's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Any, prefix: str) -> None:
        if _is_linear(node):
            sd[prefix + "weight"] = _t(node["w"]).t().contiguous()
            sd[prefix + "bias"] = _t(node["b"])
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            sd[prefix[:-1]] = _t(node)

    walk(params, "")
    return sd


def params_to_jax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` -> the JAX package's params tree as numpy
    arrays (the inverse of :func:`params_from_jax`)."""
    root: Dict[Any, Any] = {}
    for name, t in sd.items():
        parts: List[Any] = [int(p) if p.isdigit() else p for p in name.split(".")]
        a = _n(t)
        if parts[-1] in ("weight", "bias"):
            a = a.T.copy() if parts[-1] == "weight" else a
            parts[-1] = "w" if parts[-1] == "weight" else "b"
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a

    def lists(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def jax_named_leaves(sd: Dict[str, torch.Tensor]) -> List[Tuple[str, np.ndarray]]:
    """(the JAX package's "/"-joined leaf path, the leaf in its layout) of
    every param, in the JAX tree-flatten order."""
    return [("/".join(map(str, p)), a) for p, a in _leaves_with_paths(params_to_jax(sd))]


def jax_path(name: str) -> str:
    """The JAX package's "/"-joined leaf path of a port param name
    (``mlp.0.weight`` -> ``mlp/0/w``, ``experts.0.w`` -> ``experts/0/w``)."""
    parts = name.split(".")
    parts[-1] = {"weight": "w", "bias": "b"}.get(parts[-1], parts[-1])
    return "/".join(parts)


# the zoo's converters: one naming rule serves every model
deepfm_params_from_jax = lr_params_from_jax = wide_deep_params_from_jax = params_from_jax
dcn_params_from_jax = mmoe_params_from_jax = rank_deepfm_params_from_jax = params_from_jax
deepfm_params_to_jax = lr_params_to_jax = wide_deep_params_to_jax = params_to_jax
dcn_params_to_jax = mmoe_params_to_jax = rank_deepfm_params_to_jax = params_to_jax


def adam_state_from_optax(count: Any, mu: Dict[str, Any], nu: Dict[str, Any]) -> AdamState:
    """optax ``ScaleByAdamState(count, mu, nu)`` of a JAX zoo model (numpy
    leaves) -> the port's :class:`AdamState`, mapped as the params are."""
    return AdamState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32),
        mu=params_from_jax(mu),
        nu=params_from_jax(nu),
    )


def adam_state_to_optax(state: AdamState) -> Tuple[np.ndarray, Dict[str, Any], Dict[str, Any]]:
    """The port's :class:`AdamState` -> ``(count, mu, nu)`` in optax's
    layout as numpy (the inverse of :func:`adam_state_from_optax`)."""
    return (
        np.asarray(int(state.count), dtype=np.int32),
        params_to_jax(state.mu),
        params_to_jax(state.nu),
    )


def _leaf_paths(tree: Dict[str, Any]) -> List[tuple]:
    """The key path of each leaf of a JAX params tree, in tree-flatten
    order."""
    return [p for p, _ in _leaves_with_paths(tree)]


def _get(tree: Any, path: tuple) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _skeleton(tree: Any) -> Any:
    """``tree``'s dicts and lists with every leaf None."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def _tree_from_leaves(template: Dict[str, Any], leaves: Sequence[Any]) -> Dict[str, Any]:
    """A params tree shaped like ``template`` holding ``leaves`` in
    :func:`_leaf_paths` order."""
    tree = _skeleton(template)
    for path, leaf in zip(_leaf_paths(template), leaves):
        _get(tree, path[:-1])[path[-1]] = leaf
    return tree


def _is_zero(state: AdamState) -> bool:
    """A ZeRO-1 stacked state: one flat moment vector a chunk."""
    return set(state.mu) == {"flat"}


def dense_leaf_names(
    params: Dict[str, torch.Tensor], zero: bool = False, multi_steps: bool = False
) -> List[str]:
    """The key path of every leaf of ``(params, optax.adam(lr).init(params))``
    as the JAX package flattens it, for a port zoo model's ``params``: the
    params, then Adam's ``count``, its first moments and its second
    moments in the params' order (the learning-rate stage's empty state has
    no leaf). With ``multi_steps`` the state is ``optax.MultiSteps(adam,
    k)``'s: ``mini_step``, ``gradient_step``, Adam's leaves, then
    ``acc_grads`` in the params' order (its ``skip_state`` is empty)."""
    keys = ["".join(f"[{p!r}]" for p in path) for path in _leaf_paths(params_to_jax(params))]
    adam = "[1].inner_opt_state[0]" if multi_steps else "[1][0]"
    moments = [""] if zero else keys  # the stacked chunk state: one flat leaf each
    names = [f"[0]{k}" for k in keys]
    if multi_steps:
        names += ["[1].mini_step", "[1].gradient_step"]
    names += [f"{adam}.count"] + [f"{adam}.mu{k}" for k in moments] + [f"{adam}.nu{k}" for k in moments]
    if multi_steps:
        names += [f"[1].acc_grads{k}" for k in moments]
    return names


def _adam_leaves(state: AdamState, paths: List[tuple]) -> List[np.ndarray]:
    if _is_zero(state):
        return [_n(state.count).astype(np.int32), _n(state.mu["flat"]), _n(state.nu["flat"])]
    count, mu, nu = adam_state_to_optax(state)
    return [count] + [_get(mu, p) for p in paths] + [_get(nu, p) for p in paths]


def dense_to_jax_leaves(params: Dict[str, torch.Tensor], state: Any) -> List[np.ndarray]:
    """The port's params and optimizer state (an :class:`AdamState` or a
    ``MultiStepsState`` of one, each either whole or ZeRO-1's stacked
    chunk state) -> the JAX package's dense leaves (numpy, JAX's [in, out]
    layout), in :func:`dense_leaf_names`' order."""
    tree = params_to_jax(params)
    paths = _leaf_paths(tree)
    leaves = [_get(tree, p) for p in paths]
    if not isinstance(state, MultiStepsState):
        return leaves + _adam_leaves(state, paths)
    inner = state.inner_opt_state
    if _is_zero(inner):
        acc = [_n(state.acc_grads["flat"])]
    else:
        acc_tree = params_to_jax(state.acc_grads)
        acc = [_get(acc_tree, p) for p in paths]
    steps = [_n(state.mini_step).astype(np.int32), _n(state.gradient_step).astype(np.int32)]
    return leaves + steps + _adam_leaves(inner, paths) + acc


def _adam_from_leaves(leaves: Sequence[np.ndarray], ref: Dict[str, Any], zero: bool) -> AdamState:
    """An :class:`AdamState` (on the host) from its JAX-ordered leaves."""
    if zero:
        return AdamState(
            count=torch.from_numpy(np.array(leaves[0], dtype=np.int32)),
            mu={"flat": _t(leaves[1])},
            nu={"flat": _t(leaves[2])},
        )
    k = len(_leaf_paths(ref))
    return adam_state_from_optax(
        leaves[0], _tree_from_leaves(ref, leaves[1 : k + 1]), _tree_from_leaves(ref, leaves[k + 1 : 2 * k + 1])
    )


def dense_from_jax_leaves(
    leaves: Sequence[np.ndarray], like: Dict[str, torch.Tensor], device: torch.device
) -> Tuple[Dict[str, torch.Tensor], Any]:
    """The inverse of :func:`dense_to_jax_leaves`: JAX-ordered dense leaves
    -> (params, optimizer state) on ``device`` for a model whose params
    look like ``like``. The leaf count and the rank of the first state
    leaf tell the four kinds apart: Adam (3k + 1 leaves for k params),
    MultiSteps of Adam (4k + 3), and ZeRO-1's stacked states of each (k +
    3, k + 6, their first state leaf [n]). Raises ``ValueError`` on a leaf
    count or a shape that differs."""
    ref = params_to_jax(like)
    paths = _leaf_paths(ref)
    k = len(paths)
    n = len(leaves)
    zero = n > k and np.ndim(leaves[k]) == 1
    kinds = {(True, k + 3): False, (True, k + 6): True, (False, 3 * k + 1): False, (False, 4 * k + 3): True}
    if (zero, n) not in kinds:
        raise ValueError(
            f"checkpoint holds {n} leaves but the current (params, opt_state) tree has "
            f"{3 * k + 1} (Adam) or {4 * k + 3} (MultiSteps of Adam)"
        )
    multi = kinds[(zero, n)]
    want = [np.shape(_get(ref, p)) for p in paths]
    if not zero:
        state_shapes = [()] + want + want + (want if multi else [])
        for got, w in zip(leaves, want + ([(), ()] if multi else []) + state_shapes):
            if np.shape(got) != w:
                raise ValueError(f"dense checkpoint shape mismatch {w} vs {np.shape(got)}")
    params = {name: t.to(device) for name, t in params_from_jax(_tree_from_leaves(ref, leaves[:k])).items()}
    rest = list(leaves[k:])
    if multi:
        mini, grad_step, rest = rest[0], rest[1], rest[2:]
    n_adam = 3 if zero else 2 * k + 1
    state: Any = _adam_from_leaves(rest[:n_adam], ref, zero)
    if multi:
        acc = {"flat": _t(rest[n_adam])} if zero else params_from_jax(_tree_from_leaves(ref, rest[n_adam:]))
        state = MultiStepsState(
            mini_step=torch.from_numpy(np.array(mini, dtype=np.int32)),
            gradient_step=torch.from_numpy(np.array(grad_step, dtype=np.int32)),
            inner_opt_state=state,
            acc_grads=acc,
        )
    return params, tree_map(lambda t: t.to(device), state)


# ---- a JAX mesh state -> one rank's -----------------------------------------


def mesh_table_block(table: Any, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block [cap, W] of a JAX mesh table [n, cap, W]."""
    return _t(np.asarray(table)[rank])


def _pick(tree: Any, i: int) -> Any:
    """Entry ``i`` of every leaf's leading axis of a params tree."""
    return _tree_from_leaves(tree, [np.asarray(x)[i] for _, x in _leaves_with_paths(tree)])


def _stack(trees: Sequence[Any]) -> Any:
    """Params trees of one structure, stacked leaf by leaf on a new leading axis."""
    leaves = [[x for _, x in _leaves_with_paths(t)] for t in trees]
    return _tree_from_leaves(trees[0], [np.stack(xs) for xs in zip(*leaves)])


def mesh_kstep_replica(params: Dict[str, Any], count: Any, mu: Dict[str, Any], nu: Dict[str, Any], rank: int):
    """Rank ``rank``'s replica of a JAX kstep state, whose params and Adam
    moments carry a leading [n] replica axis (numpy leaves): (params,
    AdamState) in the port's naming."""
    return params_from_jax(_pick(params, rank)), adam_state_from_optax(
        np.asarray(count)[rank], _pick(mu, rank), _pick(nu, rank)
    )


def mesh_zero_chunk(count: Any, mu: Any, nu: Any, rank: int) -> AdamState:
    """Chunk ``rank`` of a JAX ZeRO-1 state (count [n], moments [n, c])."""
    return AdamState(
        count=torch.tensor(int(np.asarray(count)[rank]), dtype=torch.int32),
        mu={"flat": _t(np.asarray(mu)[rank])},
        nu={"flat": _t(np.asarray(nu)[rank])},
    )


def pipeline_stage_from_jax(params: Dict[str, Any], count: Any, mu: Any, nu: Any, stage: int,
                            chunk: Any = None) -> Tuple[Dict[str, torch.Tensor], AdamState]:
    """Stage ``stage``'s (params, AdamState) of a JAX pipeline state
    (numpy leaves): params, count [n_pp] and moments stacked on the stage
    axis. With ``chunk`` (ZeRO-1) the state is chunk ``(stage, chunk)``'s
    of count [n_pp, n_dp] and moments [n_pp, n_dp, c]."""
    if chunk is None:
        return mesh_kstep_replica(params, count, mu, nu, stage)
    return params_from_jax(_pick(params, stage)), mesh_zero_chunk(
        np.asarray(count)[stage], np.asarray(mu)[stage], np.asarray(nu)[stage], chunk
    )


def pipeline_state_to_jax(stages: Sequence[Tuple[Dict[str, torch.Tensor], Any]]):
    """The inverse of :func:`pipeline_stage_from_jax`: ``stages`` in stage
    order, each ``(params, state)`` where ``state`` is the stage's
    AdamState, or under ZeRO-1 the list of its chunks' AdamStates in dp
    order. Returns ``(params, count, mu, nu)`` stacked as the JAX state
    holds them (numpy)."""
    params = _stack([params_to_jax(p) for p, _ in stages])
    if isinstance(stages[0][1], AdamState):
        count, mu, nu = zip(*(adam_state_to_optax(st) for _, st in stages))
        return params, np.stack(count), _stack(mu), _stack(nu)
    count = np.array([[int(c.count) for c in chunks] for _, chunks in stages], dtype=np.int32)
    mu, nu = (np.stack([np.stack([_n(getattr(c, m)["flat"]) for c in chunks]) for _, chunks in stages])
              for m in ("mu", "nu"))
    return params, count, mu, nu
