"""The regression surrogate's training step in plain PyTorch: the
benchmark's reference for one step of fea-diffusion's train_model.py.

The image head's mean L1 loss on the geometry-masked prediction, the
gradient of the active modules (encoder and decoder), clip by global norm
per module (optax.clip_by_global_norm), then Adam (optax.adam: eps outside
the square root, bias correction by the step count).
"""

from typing import Dict, List

import torch
import torch.nn.functional as F

from .fdnunet import regression_prediction

KEYS = ("encoder", "decoder")


def l1_loss(encoder, decoder, batch: Dict[str, torch.Tensor], route=None) -> torch.Tensor:
    prediction = regression_prediction(encoder, decoder, batch, route)
    return (prediction - batch["displacement"]).abs().mean()


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    divisor = 1.0 if norm < max_norm else norm / max_norm
    return [g / divisor for g in grads]


class Adam:
    def __init__(self, params: List[torch.Tensor], lr, b1, b2, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        self.count += 1
        c1 = 1.0 - self.b1**self.count
        c2 = 1.0 - self.b2**self.count
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def max_routes(out: torch.Tensor, tol: float, limit: int):
    """The pixels through which the output's spatial maximum can take its
    gradient when rounding decides: for each (image, channel) of the
    decoder's output before normalizing (NCHW), the local maxima (3x3)
    within `tol` of the maximum, relative. Returns the argmax (B, C) and
    [(image, channel, flat index)] of the other such peaks, the closest to
    the maximum first, at most `limit`, and how many there were."""
    b, c, h, w = out.shape
    flat = out.reshape(b, c, h * w)
    m = flat.amax(-1)
    peaks = (out == F.max_pool2d(out, 3, 1, 1)).reshape(b, c, h * w)
    near = peaks & (flat >= (m - tol * m.abs())[..., None])
    argmax = flat.argmax(-1)
    near[torch.arange(b)[:, None], torch.arange(c)[None, :], argmax] = False
    found = sorted(((float(m[i, j] - flat[i, j, k]), i, j, k)
                    for i, j, k in near.nonzero().tolist()))
    return argmax, [(i, j, k) for _, i, j, k in found[:limit]], len(found)


def gradients(modules, batch, route=None) -> List[torch.Tensor]:
    """The loss's gradient of every encoder and decoder leaf, unclipped, the
    output maximum's gradient through `route`."""
    loss = l1_loss(modules["encoder"], modules["decoder"], batch, route)
    params = [p for k in KEYS for p in modules[k].parameters()]
    return [g.detach() for g in torch.autograd.grad(loss, params)]


def route_choices(modules, batch, argmax, alternates):
    """The first gradient for every way of routing the near-tied maxima,
    as (label, gradients), one at a time: the backward is linear in the
    output's gradient, so a route that moves several (image, channel)
    maxima gives the argmax gradient plus each move's change. One move
    per (image, channel) at most; every combination while there are at
    most 256."""
    base = gradients(modules, batch, argmax)
    moves = {}
    for i, j, k in alternates:
        route = argmax.clone()
        route[i, j] = k
        moves.setdefault((i, j), []).append(
            (k, [a - b for a, b in zip(gradients(modules, batch, route), base)]))
    combos = [[]]
    for options in moves.values():
        extended = [c + [o] for c in combos for o in options]
        combos = combos + extended if len(combos) + len(extended) <= 256 else combos
    for combo in combos:
        grads = list(base)
        for _, delta in combo:
            grads = [g + d for g, d in zip(grads, delta)]
        yield ",".join(str(k) for k, _ in combo) or "argmax", grads


def clip_modules(grads: List[torch.Tensor], sizes) -> List[torch.Tensor]:
    """grads split by module (`sizes` leaves each), each module clipped by
    its global norm as the optimizer clips it."""
    out, start = [], 0
    for n, max_norm in sizes:
        out += clip_by_global_norm(grads[start:start + n], max_norm)
        start += n
    return out


def train_steps(modules: Dict[str, torch.nn.Module], batches, lr, betas, max_norm) -> list:
    """Steps of the reference over `batches` (a list of device batches),
    updating the parameters of `modules` ({"encoder", "decoder"}) in place;
    returns the losses."""
    params = {k: list(modules[k].parameters()) for k in KEYS}
    opts = {k: Adam(params[k], lr, *betas) for k in KEYS}
    losses = []
    for batch in batches:
        loss = l1_loss(modules["encoder"], modules["decoder"], batch)
        grads = torch.autograd.grad(loss, [p for k in KEYS for p in params[k]])
        losses.append(float(loss.detach()))
        start = 0
        for k in KEYS:
            n = len(params[k])
            opts[k].step(params[k], clip_by_global_norm(list(grads[start:start + n]), max_norm))
            start += n
    return losses
