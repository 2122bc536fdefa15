"""Model facade: a module that owns its parameters on one device, with
forward / prefill / decode for an architecture config.

Port of `repro.models.model`.  The reference's `Model` is a stateless
wrapper that takes a parameter pytree at every call; here `Model` is an
`nn.Module` holding the parameter tree (dicts as submodules, layer lists
as `nn.ModuleList`s, top-level tensors such as the vlm's `img_proj` and
the encdec's `enc_pos` / `dec_pos` as parameters), so its `state_dict`
keys are the tree's dotted paths (`layers.0.attn.wq`, `embed.table`,
`dec_layers.1.cross_attn.wk`; `interop.model_params` builds one from the
reference's pytree).  The weights the passes read are cast once to the
activation dtype at the first call after `init` / `load_params`
(`transformer.cast_params`).

Training is functional, as the reference's: `loss(batch, params)` reads a
flat `{dotted path: tensor}` dict of master leaves (the parameter dtype,
float32 in every registered config) that the caller made take gradients
(`master_params`, `train.train_step`), casts them to the activation dtype
inside the graph on every call and never touches the serving cache.
`prefill` and `decode_step` run under `inference_mode` on the tree cast
once.

`use_kernel` is the reference transformer's switch, carried to `forward`
and `prefill`: it sends the rwkv6 and RG-LRU recurrences to their kernels.
It defaults to False, as the reference's facade and launcher leave it.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from ..parallel.sharding import (is_dtensor, logical_constraint,
                                 plain_as_replicated)
from . import layers as L
from . import transformer as T
from .config import ModelConfig


def _register(module: nn.Module, tree: Mapping) -> None:
    """Dicts become submodules, lists module lists and tensors parameters
    (without gradients) of `module`."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            module.add_module(k, ParamTree(v))
        elif isinstance(v, list):
            module.add_module(k, nn.ModuleList(ParamTree(x) for x in v))
        else:
            module.register_parameter(k, nn.Parameter(v, requires_grad=False))


def _tree(module: nn.Module, flat: Mapping | None = None, prefix: str = ""):
    """The nested dicts and lists of parameters `_register` made; with
    `flat`, the same structure holding `flat[dotted path]` in place of each
    parameter (a KeyError names a path `flat` lacks)."""
    if isinstance(module, nn.ModuleList):
        return [_tree(m, flat, f"{prefix}{i}.") for i, m in enumerate(module)]
    out = {k: _tree(m, flat, f"{prefix}{k}.")
           for k, m in module._modules.items()}
    out.update(module._parameters if flat is None else
               {k: flat[prefix + k] for k in module._parameters})
    return out


def _nll(lg: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """logsumexp(lg) - lg[tgt] over the last dim (the vocab), float32.
    A DTensor split over the vocab takes a vocab-parallel form
    of the same numbers: torch's own logsumexp written out (the max,
    non-finite maxes set to 0, log of the sum of exp(lg - max), plus the
    max), the max out of the graph (its gradient is zero), and the gold
    logit as the sum over the vocab of lg where the vocab id is the
    target (one term, so the gather's value).  Each rank reduces its own
    slice of the vocab, and only [B, T] partial results cross the mesh
    (DTensor would gather the whole logits for logsumexp and gather)."""
    d = lg.ndim - 1
    if not (is_dtensor(lg) and any(p.is_shard(d) for p in lg.placements)):
        return torch.logsumexp(lg, dim=-1) \
            - torch.gather(lg, -1, tgt[..., None])[..., 0]
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    ids = distribute_tensor(
        torch.arange(lg.shape[d], device=lg.device), lg.device_mesh,
        [Shard(0) if p.is_shard(d) else Replicate() for p in lg.placements],
        src_data_rank=None)
    m = logical_constraint(lg.detach().amax(-1, keepdim=True),
                           ("batch", None, None))
    m = torch.where(m.abs() == float("inf"), 0.0, m)
    total = logical_constraint(torch.exp(lg - m).sum(-1), ("batch", None))
    gold = logical_constraint(torch.where(ids == tgt[..., None], lg,
                                          0.0).sum(-1), ("batch", None))
    return logical_constraint(torch.log(total) + m[..., 0] - gold,
                              ("batch", None))


class ParamTree(nn.Module):
    """A nested dict of tensors as a module."""

    def __init__(self, tree: Mapping):
        super().__init__()
        _register(self, tree)

    def tree(self) -> dict:
        return _tree(self)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda", use_kernel=False):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        # every drawn leaf allocated, uninitialised, and noted for `init`
        self._draws = L.Draws()
        _register(self, T.init_params(self._draws, cfg, self.device))
        self._cast = None

    # -- parameters ---------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw the parameters of a new model from `generator` (the
        reference's distributions; the generator may live on the CPU or
        the card): leaf by leaf, straight into each parameter, with the
        numbers `transformer.init_params(generator, ...)` would give, so
        the weights exist once while they are drawn."""
        self._draws.fill(generator)
        self._cast = None
        return self

    @torch.no_grad()
    def load_params(self, state: Mapping[str, torch.Tensor]) -> "Model":
        """Copy a full state dict (dotted paths) into the parameters."""
        self.load_state_dict(dict(state), strict=True)
        self._cast = None
        return self

    def params(self) -> dict:
        """The parameter tree as the passes read it (cast once)."""
        if self._cast is None:
            self._cast = T.cast_params(_tree(self), self.cfg)
        return self._cast

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def master_params(self) -> dict[str, torch.Tensor]:
        """`{dotted path: tensor}` of the parameters as training reads
        them: detached, in the parameter dtype, sharing the module's
        storage (the train step never writes into its inputs)."""
        return {k: v.detach() for k, v in self.state_dict().items()}

    # -- forward ------------------------------------------------------------
    @torch.inference_mode()
    def logits(self, batch: dict):
        """(logits [B, T, V], aux loss) for batch['tokens'] [B, T], with
        batch['img_embeds'] (vlm) or batch['audio_frames'] (encdec)."""
        return T.forward(self.params(), self.cfg, batch["tokens"],
                         img_embeds=batch.get("img_embeds"),
                         audio_frames=batch.get("audio_frames"),
                         use_kernel=self.use_kernel)

    # -- training -----------------------------------------------------------
    def loss(self, batch: dict, params: Mapping | None = None
             ) -> torch.Tensor:
        """Next-token cross entropy (+ MoE aux), float32 over the padded
        vocab: `logsumexp` minus the gold logit on `tokens[:, 1:]`, meaned
        over the `loss_mask` where the batch has one.  `params` is a flat
        `{dotted path: tensor}` dict (the module's own parameters when
        None), cast to the activation dtype inside the graph.  With
        DTensor leaves (`parallel.sharding.place_params`) the batch is
        placed too (`place_batch`), and the tensors the passes make count
        as replicated (`sharding.plain_as_replicated`)."""
        with plain_as_replicated(params):
            logits, aux = T.forward(
                T.cast_params(_tree(self, params), self.cfg), self.cfg,
                batch["tokens"], img_embeds=batch.get("img_embeds"),
                audio_frames=batch.get("audio_frames"),
                use_kernel=self.use_kernel)
            tgt = batch["tokens"][:, 1:].long()
            lg = logits[:, :-1]
            nll = _nll(lg, tgt)
            mask = batch.get("loss_mask")
            if mask is not None:
                m = mask[:, 1:].to(torch.float32)
                nll = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
            else:
                nll = nll.mean()
            return nll + aux

    # -- serving ------------------------------------------------------------
    def init_decode_state(self, batch: int, seq: int):
        return T.init_decode_state(self.cfg, batch, seq, self.device)

    @torch.inference_mode()
    def prefill(self, batch: dict, state):
        """Fused full-prompt forward that fills the decode caches; the
        batch carries 'img_embeds' / 'audio_frames' as `logits` takes
        them."""
        return T.prefill(self.params(), self.cfg, batch, state,
                         use_kernel=self.use_kernel)

    @torch.inference_mode()
    def decode_step(self, token, state):
        return T.decode_step(self.params(), self.cfg, token, state)


def make_model(cfg: ModelConfig, device="cuda", use_kernel=False) -> Model:
    return Model(cfg, device, use_kernel)
