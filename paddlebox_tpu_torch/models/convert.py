"""Carry DeepFM weights and Adam state between the JAX package and the port.

The JAX DeepFM keeps ``{"mlp": [{"w": [in, out], "b": [out]}, ...],
"out": {"w", "b"}, "b": scalar, "dense_lin"?: {"w", "b"}}``; ``nn.Linear``
keeps ``weight`` as [out, in]. Callers hand the pytree over as numpy
arrays (``jax.tree.map(np.asarray, params)``), so this module needs no JAX.

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


def adam_state_from_optax(count: Any, mu: Dict[str, Any], nu: Dict[str, Any]) -> AdamState:
    """optax ``ScaleByAdamState(count, mu, nu)`` of a JAX DeepFM (numpy
    leaves) -> the port's :class:`AdamState`, with the same transposes as
    :func:`deepfm_params_from_jax`."""
    return AdamState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32),
        mu=deepfm_params_from_jax(mu),
        nu=deepfm_params_from_jax(nu),
    )


def adam_state_to_optax(state: AdamState) -> Tuple[np.ndarray, Dict[str, Any], Dict[str, Any]]:
    """The port's :class:`AdamState` -> ``(count, mu, nu)`` in optax's
    layout as numpy (the inverse of :func:`adam_state_from_optax`)."""
    return (
        np.asarray(int(state.count), dtype=np.int32),
        deepfm_params_to_jax(state.mu),
        deepfm_params_to_jax(state.nu),
    )



def _leaf_paths(tree: Dict[str, Any]) -> List[tuple]:
    """The key path of each leaf of a JAX DeepFM params tree, in the order
    a JAX tree flatten visits them: dict keys sorted (``b``,
    ``dense_lin``, ``mlp``, ``out``), list items in order, ``b`` before
    ``w`` within a layer."""
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


def _tree_from_leaves(template: Dict[str, Any], leaves: Sequence[Any]) -> Dict[str, Any]:
    """A params tree shaped like ``template`` holding ``leaves`` in
    :func:`_leaf_paths` order."""
    tree: Dict[str, Any] = {
        "mlp": [{} for _ in template["mlp"]], "out": {}, **({"dense_lin": {}} if "dense_lin" in template else {})
    }
    for path, leaf in zip(_leaf_paths(template), leaves):
        if len(path) == 1:
            tree[path[0]] = leaf
        else:
            _get(tree, path[:-1])[path[-1]] = leaf
    return tree


def dense_leaf_names(params: Dict[str, torch.Tensor]) -> List[str]:
    """The key path of every leaf of ``(params, optax.adam(lr).init(params))``
    as the JAX package flattens it, for the port's DeepFM ``params``: the
    params, then Adam's ``count``, its first moments and its second moments
    in the params' order (the learning-rate stage's empty state has no
    leaf)."""
    keys = ["".join(f"[{p!r}]" for p in path) for path in _leaf_paths(deepfm_params_to_jax(params))]
    return (
        [f"[0]{k}" for k in keys] + ["[1][0].count"]
        + [f"[1][0].mu{k}" for k in keys] + [f"[1][0].nu{k}" for k in keys]
    )


def dense_to_jax_leaves(params: Dict[str, torch.Tensor], state: AdamState) -> List[np.ndarray]:
    """The port's params and Adam state -> the JAX package's dense leaves
    (numpy, JAX's [in, out] layout), in :func:`dense_leaf_names`' order."""
    tree = deepfm_params_to_jax(params)
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
    ref = deepfm_params_to_jax(like)
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
    params = {n: t.to(device) for n, t in deepfm_params_from_jax(tree(leaves[:k])).items()}
    return params, AdamState(
        count=state.count.to(device),
        mu={n: t.to(device) for n, t in state.mu.items()},
        nu={n: t.to(device) for n, t in state.nu.items()},
    )
