"""Carry DeepFM weights from the JAX package's pytree to the port's module.

The JAX DeepFM keeps ``{"mlp": [{"w": [in, out], "b": [out]}, ...],
"out": {"w", "b"}, "b": scalar, "dense_lin"?: {"w", "b"}}``; ``nn.Linear``
keeps ``weight`` as [out, in]. Callers hand the pytree over as numpy
arrays (``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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
