"""Functional Adam for the dense parameters.

The counterpart of ``optax.adam``, which the JAX package takes from a
library, with the same arithmetic per parameter tensor:

    mu    = (1 - b1) * g   + b1 * mu
    nu    = (1 - b2) * g^2 + b2 * nu
    count = count + 1
    mu_hat = mu / (1 - b1^count),  nu_hat = nu / (1 - b2^count)
    update = -lr * mu_hat / (sqrt(nu_hat) + eps)
    param  = param + update

The state is an explicit :class:`AdamState` of plain tensors, keyed like the
parameter dict (a module's ``state_dict`` names), so it can sit in
``TrainState.opt_state`` and be compared with optax leaf for leaf
(``models/convert.py`` carries it across). Updates are functional: new
tensors come back and the inputs are left as they were.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar: updates applied so far
    mu: Params  # first moments, one per parameter
    nu: Params  # second moments


@dataclass(frozen=True)
class Adam:
    """``optax.adam``'s counterpart (no ``eps_root``, no Nesterov)."""

    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params) -> AdamState:
        some = next(iter(params.values()))
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=some.device),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def update(self, grads: Params, state: AdamState) -> Tuple[Params, AdamState]:
        """(updates to add to the params, the new state)."""
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        c = count.to(torch.float32)
        # torch.full fills on the device; torch.tensor would copy the
        # scalar from the host and wait for the card
        bc1 = 1 - torch.pow(torch.full((), b1, dtype=torch.float32, device=c.device), c)
        bc2 = 1 - torch.pow(torch.full((), b2, dtype=torch.float32, device=c.device), c)
        updates = {
            k: -self.learning_rate * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps))
            for k in grads
        }
        return updates, AdamState(count=count, mu=mu, nu=nu)

