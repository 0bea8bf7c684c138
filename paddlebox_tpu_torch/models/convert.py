"""Carry DeepFM weights and Adam state between the JAX package and the port.

The JAX DeepFM keeps ``{"mlp": [{"w": [in, out], "b": [out]}, ...],
"out": {"w", "b"}, "b": scalar, "dense_lin"?: {"w", "b"}}``; ``nn.Linear``
keeps ``weight`` as [out, in]. Callers hand the pytree over as numpy
arrays (``jax.tree.map(np.asarray, params)``), so this module needs no JAX.

Adam's moments follow the same map (optax keeps them in the params' tree;
the port keeps them keyed like the ``state_dict``). Each function has its
inverse, so weights and state can be carried across and compared back.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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
