"""Train-step factory: loss + grad + AdamW, with microbatch gradient
accumulation and optional int8 gradient compression.

Port of `repro.train.train_step`.  The step is a function of its inputs,
as the reference's: it reads `params` (a flat `{dotted path: tensor}`
dict, `Model.master_params`) and the optimizer state, writes into
neither, and returns new ones.  Gradients come from `torch.autograd.grad`
on leaves detached from the caller's tensors; a leaf the loss does not
reach gets a zero gradient, as `jax.grad` gives it.  On a mesh the leaves
are DTensors placed by `parallel.sharding.validated_pspecs` and the batch
is placed by `batch_pspec`; the step means the same, each gradient comes
out laid out as its parameter, and the metrics come out whole.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.model import Model
from ..parallel.sharding import (full_tensor, placed_as,
                                 plain_as_replicated)
from . import compression
from .optimizer import AdamWConfig, adamw_update, init_opt_state  # noqa: F401


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1            # gradient accumulation steps
    # the reference's 'loop' (fori_loop) and 'unroll' (python loop, for
    # exact XLA cost analysis); both are a python loop here
    microbatch_impl: str = "loop"
    compress_grads: bool = False     # int8 channel (multi-pod DCN)
    seed: int = 0


def loss_and_grads(model: Model, params, batch):
    """(loss, {path: gradient in the parameter's dtype}) of `model.loss`
    at `params`, neither attached to a graph."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with plain_as_replicated(params):
        loss = model.loss(batch, leaves)
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
        # on a mesh, each gradient laid out as its parameter
        grads = {k: torch.zeros_like(v) if g is None else placed_as(g, v)
                 for (k, v), g in zip(leaves.items(), gs)}
    return loss.detach(), grads


def _micro_slice(batch: dict, i: int, n: int) -> dict:
    return {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
            for k, v in batch.items()}


def make_train_step(model: Model, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)."""
    if tcfg.microbatch_impl not in ("loop", "unroll"):
        raise ValueError(f"microbatch_impl is 'loop' or 'unroll', got "
                         f"{tcfg.microbatch_impl!r}")

    def train_step(params, opt_state, batch, step):
        with plain_as_replicated(params):
            return _step(params, opt_state, batch, step)

    def _step(params, opt_state, batch, step):
        n = tcfg.microbatches
        if n > 1:
            gsum = lsum = None
            for i in range(n):
                loss, g = loss_and_grads(model, params,
                                         _micro_slice(batch, i, n))
                g = {k: v.to(torch.float32) for k, v in g.items()}
                gsum = g if gsum is None else {k: gsum[k] + g[k] for k in g}
                lsum = loss if lsum is None else lsum + loss
            loss = lsum / n
            grads = {k: g / n for k, g in gsum.items()}
        else:
            loss, grads = loss_and_grads(model, params, batch)

        if tcfg.compress_grads:
            dev = next(iter(grads.values())).device
            gen = torch.Generator(device=dev).manual_seed(
                tcfg.seed * 1_000_003 + int(step))
            grads = compression.compress_roundtrip(grads, gen)

        params2, opt2, metrics = adamw_update(tcfg.opt, params, grads,
                                              opt_state)
        return params2, opt2, {k: full_tensor(v) for k, v in
                               dict(metrics, loss=loss).items()}

    return train_step


def make_eval_step(model: Model):
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss(batch, params)

    return eval_step
