"""AdamW from scratch + LR schedules + global-norm clipping.

Port of `repro.train.optimizer`.  Parameters, gradients and the moments
are flat `{dotted path: tensor}` dicts (`Model.master_params`); the
optimizer state is `{"mu": {...}, "nu": {...}, "count": int32 0-d}`, the
moments float32 whatever the parameter dtype.  The update is pure, as the
reference's: it returns new tensors and writes into none of its inputs, so
one `params` may feed two steps.  The math is float32, one leaf at a time;
the schedule, clip scale and bias corrections stay 0-d tensors on the
parameters' device, so a step never waits on the card.  DTensor leaves on
a mesh (`parallel.sharding`) take the same math, their moments laid out
alike.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"      # cosine | linear | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or a 0-d tensor), float32 0-d
    on the step's device (the CPU for an int)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
            * 0.5 * (1 + torch.cos(math.pi * frac))
    else:
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    return cfg.lr * warm * decay


def init_opt_state(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero moments laid out as their parameters (DTensors placed alike
    on a mesh) and a 0-d int32 count on the parameters' device."""
    device = next(iter(params.values())).device
    return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


def decays(path: str) -> bool:
    """No weight decay on norms, biases and the other leaves whose last
    key is `scale` or `bias` or starts with "b" (`b_up`, `bq`,
    `bonus_u`): the reference's `_decay_mask` on the last string key of the
    leaf's path, here the last part of the dotted path that is not a
    layer index."""
    name = next((p for p in reversed(path.split(".")) if not p.isdigit()),
                "")
    return not (name in ("scale", "bias") or name.startswith("b"))


def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: dict):
    """One AdamW step; returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip else 1.0)
    count = state["count"] + 1
    lr = lr_at(cfg, count)
    c1 = 1.0 - cfg.b1 ** count.to(torch.float32)
    c2 = 1.0 - cfg.b2 ** count.to(torch.float32)

    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        gf = grads[k].to(torch.float32) * scale
        mu2 = cfg.b1 * state["mu"][k] + (1 - cfg.b1) * gf
        nu2 = cfg.b2 * state["nu"][k] + (1 - cfg.b2) * gf * gf
        upd = (mu2 / c1) / (torch.sqrt(nu2 / c2) + cfg.eps)
        if cfg.weight_decay and decays(k):
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * upd).to(p.dtype)
        new_mu[k] = mu2
        new_nu[k] = nu2
    return (new_p, {"mu": new_mu, "nu": new_nu, "count": count},
            {"grad_norm": gnorm, "lr": lr})
