"""Carry DeepFM and RankDeepFM weights and Adam state between the JAX
package and the port.

The JAX DeepFM keeps ``{"mlp": [{"w": [in, out], "b": [out]}, ...],
"out": {"w", "b"}, "b": scalar, "dense_lin"?: {"w", "b"}}``; ``nn.Linear``
keeps ``weight`` as [out, in]. The JAX RankDeepFM keeps ``{"base": <a
DeepFM tree>, "rank_param": [R*R*F, 1]}``, the port's ``base.*`` and
``rank_param``. Callers hand the pytree over as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.

Adam's moments follow the same map (optax keeps them in the params' tree;
the port keeps them keyed like the ``state_dict``). Each function has its
inverse, so weights and state can be carried across and compared back.

The dense checkpoint file (``CTRTrainer.save_dense``) holds the leaves of
the JAX package's ``(params, optax.adam state)`` tree as ``leaf_0`` ..
``leaf_{n-1}``; :func:`dense_leaf_names` spells that order out, and
:func:`dense_to_jax_leaves` / :func:`dense_from_jax_leaves` carry the
port's params and :class:`AdamState` to and from it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.train.dense_opt import AdamState


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def deepfm_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX DeepFM params (numpy leaves) -> the port's DeepFM ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(params["mlp"]):
        sd[f"mlp.{i}.weight"] = _t(layer["w"]).t().contiguous()
        sd[f"mlp.{i}.bias"] = _t(layer["b"])
    sd["out.weight"] = _t(params["out"]["w"]).t().contiguous()
    sd["out.bias"] = _t(params["out"]["b"])
    sd["b"] = _t(params["b"]).reshape(())
    if "dense_lin" in params:
        sd["dense_lin.weight"] = _t(params["dense_lin"]["w"]).t().contiguous()
        sd["dense_lin.bias"] = _t(params["dense_lin"]["b"])
    return sd


def deepfm_params_to_jax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's DeepFM ``state_dict`` -> the JAX package's params tree as
    numpy arrays (the inverse of :func:`deepfm_params_from_jax`)."""

    def n(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().astype(np.float32)

    n_mlp = len({k.split(".")[1] for k in sd if k.startswith("mlp.")})
    params: Dict[str, Any] = {
        "mlp": [
            {"w": n(sd[f"mlp.{i}.weight"]).T.copy(), "b": n(sd[f"mlp.{i}.bias"])}
            for i in range(n_mlp)
        ],
        "out": {"w": n(sd["out.weight"]).T.copy(), "b": n(sd["out.bias"])},
        "b": n(sd["b"]),
    }
    if "dense_lin.weight" in sd:
        params["dense_lin"] = {
            "w": n(sd["dense_lin.weight"]).T.copy(),
            "b": n(sd["dense_lin.bias"]),
        }
    return params


def rank_deepfm_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX RankDeepFM params (numpy leaves) -> the port's RankDeepFM
    ``state_dict``: the base's keys under ``base.``, then ``rank_param``."""
    sd = {f"base.{k}": v for k, v in deepfm_params_from_jax(params["base"]).items()}
    sd["rank_param"] = _t(params["rank_param"])
    return sd


def rank_deepfm_params_to_jax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's RankDeepFM ``state_dict`` -> the JAX package's params tree
    as numpy arrays (the inverse of :func:`rank_deepfm_params_from_jax`)."""
    base = {k[len("base."):]: v for k, v in sd.items() if k.startswith("base.")}
    return {
        "base": deepfm_params_to_jax(base),
        "rank_param": sd["rank_param"].detach().cpu().numpy().astype(np.float32),
    }


def _from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Either model's JAX params tree -> its port ``state_dict``."""
    return rank_deepfm_params_from_jax(tree) if "rank_param" in tree else deepfm_params_from_jax(tree)


def _to_jax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Either model's port ``state_dict`` -> its JAX params tree."""
    return rank_deepfm_params_to_jax(sd) if "rank_param" in sd else deepfm_params_to_jax(sd)


def adam_state_from_optax(count: Any, mu: Dict[str, Any], nu: Dict[str, Any]) -> AdamState:
    """optax ``ScaleByAdamState(count, mu, nu)`` of a JAX DeepFM or
    RankDeepFM (numpy leaves) -> the port's :class:`AdamState`, mapped as
    the params are."""
    return AdamState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32),
        mu=_from_jax(mu),
        nu=_from_jax(nu),
    )


def adam_state_to_optax(state: AdamState) -> Tuple[np.ndarray, Dict[str, Any], Dict[str, Any]]:
    """The port's :class:`AdamState` -> ``(count, mu, nu)`` in optax's
    layout as numpy (the inverse of :func:`adam_state_from_optax`)."""
    return (
        np.asarray(int(state.count), dtype=np.int32),
        _to_jax(state.mu),
        _to_jax(state.nu),
    )


def _leaf_paths(tree: Dict[str, Any]) -> List[tuple]:
    """The key path of each leaf of a JAX DeepFM or RankDeepFM params
    tree, in the order a JAX tree flatten visits them: dict keys sorted
    (``b``, ``dense_lin``, ``mlp``, ``out``; ``base`` before
    ``rank_param``), list items in order, ``b`` before ``w`` within a
    layer."""
    if "rank_param" in tree:
        return [("base",) + p for p in _leaf_paths(tree["base"])] + [("rank_param",)]
    paths: List[tuple] = [("b",)]
    if "dense_lin" in tree:
        paths += [("dense_lin", "b"), ("dense_lin", "w")]
    for i in range(len(tree["mlp"])):
        paths += [("mlp", i, "b"), ("mlp", i, "w")]
    return paths + [("out", "b"), ("out", "w")]


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


def dense_leaf_names(params: Dict[str, torch.Tensor]) -> List[str]:
    """The key path of every leaf of ``(params, optax.adam(lr).init(params))``
    as the JAX package flattens it, for the port's DeepFM or RankDeepFM
    ``params``: the params, then Adam's ``count``, its first moments and
    its second moments in the params' order (the learning-rate stage's
    empty state has no leaf)."""
    keys = ["".join(f"[{p!r}]" for p in path) for path in _leaf_paths(_to_jax(params))]
    return (
        [f"[0]{k}" for k in keys] + ["[1][0].count"]
        + [f"[1][0].mu{k}" for k in keys] + [f"[1][0].nu{k}" for k in keys]
    )


def dense_to_jax_leaves(params: Dict[str, torch.Tensor], state: AdamState) -> List[np.ndarray]:
    """The port's params and Adam state -> the JAX package's dense leaves
    (numpy, JAX's [in, out] layout), in :func:`dense_leaf_names`' order."""
    tree = _to_jax(params)
    count, mu, nu = adam_state_to_optax(state)
    paths = _leaf_paths(tree)
    return (
        [_get(tree, p) for p in paths] + [count]
        + [_get(mu, p) for p in paths] + [_get(nu, p) for p in paths]
    )


def dense_from_jax_leaves(
    leaves: Sequence[np.ndarray], like: Dict[str, torch.Tensor], device: torch.device
) -> Tuple[Dict[str, torch.Tensor], AdamState]:
    """The inverse of :func:`dense_to_jax_leaves`: JAX-ordered dense leaves
    -> (params, AdamState) on ``device`` for a model whose params look like
    ``like``. Raises ``ValueError`` on a leaf count or a shape that
    differs."""
    ref = _to_jax(like)
    paths = _leaf_paths(ref)
    k = len(paths)
    if len(leaves) != 3 * k + 1:
        raise ValueError(
            f"checkpoint holds {len(leaves)} leaves but the current (params, "
            f"opt_state) tree has {3 * k + 1}"
        )
    want = [np.shape(_get(ref, p)) for p in paths]
    for got, w in zip(leaves, want + [()] + want + want):
        if np.shape(got) != w:
            raise ValueError(f"dense checkpoint shape mismatch {w} vs {np.shape(got)}")

    def tree(part):
        return _tree_from_leaves(ref, part)

    state = adam_state_from_optax(leaves[k], tree(leaves[k + 1 : 2 * k + 1]), tree(leaves[2 * k + 1 :]))
    params = {n: t.to(device) for n, t in _from_jax(tree(leaves[:k])).items()}
    return params, AdamState(
        count=state.count.to(device),
        mu={n: t.to(device) for n, t in state.mu.items()},
        nu={n: t.to(device) for n, t in state.nu.items()},
    )
