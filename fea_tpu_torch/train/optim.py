"""optax's clip_by_global_norm and adam, written out over lists of tensors.

fea_tpu's trainers chain optax.clip_by_global_norm and optax.adam; torch's
clip_grad_norm_ (its +1e-6, its handling of non-finite norms) and
torch.optim.Adam (eps inside the bias correction, a host step count) differ
from them. Everything here stays on the device: the step count is a 0-dim
int32 tensor, and `select_` lets a caller keep or drop an update by a
device-side flag, without a sync.
"""

from dataclasses import dataclass
from typing import List, Tuple

import torch


@dataclass
class AdamState:
    count: torch.Tensor  # int32, 0-dim: optax's ScaleByAdamState.count
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params: List[torch.Tensor]) -> AdamState:
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params[0].device),
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
    )


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element: inf or nan when any
    element is."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g / norm * max_norm when norm >= max_norm,
    else g. A non-finite norm gives non-finite grads, as in optax."""
    norm = global_norm(grads)
    divisor = torch.where(norm < max_norm, 1.0, norm / max_norm)
    return torch._foreach_div(grads, divisor)


@torch.no_grad()
def adam_update(
    params: List[torch.Tensor],
    grads: List[torch.Tensor],
    state: AdamState,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.99,
    eps: float = 1e-8,
) -> Tuple[List[torch.Tensor], AdamState]:
    """One optax.adam step (eps outside the square root, no eps_root), out
    of place: the new params and the new state."""
    count = state.count + 1
    mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1), torch._foreach_mul(state.mu, b1))
    nu = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2),
        torch._foreach_mul(state.nu, b2),
    )
    step = count.float()
    mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(b1, step))
    nu_hat = torch._foreach_div(nu, 1.0 - torch.pow(b2, step))
    denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
    updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom), -lr)
    return torch._foreach_add(params, updates), AdamState(count, mu, nu)


@torch.no_grad()
def select_(ok: torch.Tensor, olds: List[torch.Tensor], news: List[torch.Tensor]) -> None:
    """olds <- news where the 0-dim bool `ok` holds, in place; olds stay
    as they are (bit for bit) where it does not."""
    for old, new in zip(olds, news):
        torch.where(ok, new, old, out=old)
