"""Functional Adam for the dense parameters, and gradient merging.

:class:`Adam` is the counterpart of ``optax.adam``, which the JAX package
takes from a library, with the same arithmetic per parameter tensor:

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

:class:`MultiSteps` is ``optax.MultiSteps(opt, k)`` (the fleet strategy's
``gradient_merge``): it keeps the running mean of the last mini-steps'
gradients and hands it to the inner optimizer every k-th mini-step,
with the same arithmetic and state as optax's (see the class). Every
choice it makes is a ``torch.where`` on the card, never a read back to
the host, so a resident superstep with it makes no host sync.

:func:`tree_map` maps a function over the tensors of any of these states
(a NamedTuple of tensors and dicts of tensors), leaf by leaf.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of ``tree`` (and the matching leaves of
    ``rest``): a NamedTuple, tuple or dict of them is rebuilt alike."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The tensors of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


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



class MultiStepsState(NamedTuple):
    """``optax.MultiStepsState`` without its empty ``skip_state``."""

    mini_step: torch.Tensor  # int32 scalar: mini-steps since the last emit
    gradient_step: torch.Tensor  # int32 scalar: inner updates so far
    inner_opt_state: Any  # the inner optimizer's state (an AdamState)
    acc_grads: Params  # the running mean of this round's gradients


@dataclass(frozen=True)
class MultiSteps:
    """``optax.MultiSteps(opt, every_k_schedule)`` with an int schedule
    and the mean of the gradients (optax's defaults, no skip function).

    Each call of :meth:`update`, a mini-step:

    - ``acc = acc + (g - acc) / (mini_step + 1)`` (Welford's running
      mean, divided by the int32 count);
    - the inner update is computed from ``acc`` on every mini-step;
    - ``emit = mini_step == k - 1``: the inner state becomes the new one
      where ``emit``, the updates are multiplied by ``emit`` (so the
      params do not move on the other mini-steps), ``acc`` by ``1 -
      emit``, ``gradient_step`` advances by ``emit`` and ``mini_step``
      becomes ``(mini_step + 1) % k``.
    """

    opt: Any  # the inner optimizer: init(params), update(grads, state)
    every_k_schedule: int = 4

    def __post_init__(self):
        if not isinstance(self.every_k_schedule, int) or self.every_k_schedule < 1:
            raise ValueError(f"every_k_schedule must be an int >= 1, got {self.every_k_schedule!r}")

    def init(self, params: Params) -> MultiStepsState:
        some = next(iter(params.values()))
        zero = torch.zeros((), dtype=torch.int32, device=some.device)
        return MultiStepsState(
            mini_step=zero,
            gradient_step=zero.clone(),
            inner_opt_state=self.opt.init(params),
            acc_grads={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def update(self, grads: Params, state: MultiStepsState) -> Tuple[Params, MultiStepsState]:
        """(updates to add to the params, the new state)."""
        k = self.every_k_schedule
        n1 = state.mini_step + 1
        acc = {key: a + (grads[key] - a) / n1 for key, a in state.acc_grads.items()}
        updates, new_inner = self.opt.update(acc, state.inner_opt_state)
        emit = state.mini_step == k - 1
        keep = 1 - emit.to(torch.int32)
        return {key: emit * u for key, u in updates.items()}, MultiStepsState(
            mini_step=n1 % k,
            gradient_step=torch.where(emit, state.gradient_step + 1, state.gradient_step),
            inner_opt_state=tree_map(lambda new, old: torch.where(emit, new, old), new_inner, state.inner_opt_state),
            acc_grads={key: keep * a for key, a in acc.items()},
        )
