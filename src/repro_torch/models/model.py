"""Model facade: a module that owns its parameters on one device, with
forward / prefill / decode for an architecture config.

Port of `repro.models.model`.  The reference's `Model` is a stateless
wrapper that takes a parameter pytree at every call; here `Model` is an
`nn.Module` holding the parameter tree (layers in an `nn.ModuleList`), so
its `state_dict` keys are the tree's dotted paths (`layers.0.attn.wq`,
`embed.table`; `interop.model_params` builds one from the reference's
pytree).  The weights the passes read are cast once to the activation dtype
at the first call after `init` / `load_params` (`transformer.cast_params`).

`use_kernel` is the reference transformer's switch, carried to `forward`
and `prefill`: it sends the rwkv6 and RG-LRU recurrences to their kernels.
It defaults to False, as the reference's facade and launcher leave it.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from . import transformer as T
from .config import ModelConfig


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dicts become submodules and
    tensors parameters (without gradients)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out = {k: m.tree() for k, m in self._modules.items()}
        out.update(self._parameters)
        return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda", use_kernel=False):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        tree = T.init_params(None, cfg, self.device)
        self.layers = nn.ModuleList(ParamTree(lp) for lp in tree.pop("layers"))
        for k, v in tree.items():
            self.add_module(k, ParamTree(v))
        self._cast = None

    # -- parameters ---------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from `generator` (the reference's
        distributions; the generator may live on the CPU or the card)."""
        tree = T.init_params(generator, self.cfg, self.device)
        return self.load_params(_flatten(tree))

    @torch.no_grad()
    def load_params(self, state: Mapping[str, torch.Tensor]) -> "Model":
        """Copy a full state dict (dotted paths) into the parameters."""
        self.load_state_dict(dict(state), strict=True)
        self._cast = None
        return self

    def params(self) -> dict:
        """The parameter tree as the passes read it (cast once)."""
        if self._cast is None:
            tree = {k: m.tree() for k, m in self.named_children()
                    if k != "layers"}
            tree["layers"] = [m.tree() for m in self.layers]
            self._cast = T.cast_params(tree, self.cfg)
        return self._cast

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- forward ------------------------------------------------------------
    @torch.inference_mode()
    def logits(self, batch: dict):
        """(logits [B, T, V], aux loss) for batch['tokens'] [B, T]."""
        return T.forward(self.params(), self.cfg, batch["tokens"],
                         use_kernel=self.use_kernel)

    # -- serving ------------------------------------------------------------
    def init_decode_state(self, batch: int, seq: int) -> list:
        return T.init_decode_state(self.cfg, batch, seq, self.device)

    @torch.inference_mode()
    def prefill(self, batch: dict, state: list):
        """Fused full-prompt forward that fills the decode caches."""
        return T.prefill(self.params(), self.cfg, batch, state,
                         use_kernel=self.use_kernel)

    @torch.inference_mode()
    def decode_step(self, token, state: list):
        return T.decode_step(self.params(), self.cfg, token, state)


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, item in enumerate(v):
                out.update(_flatten(item, f"{prefix}{k}.{i}."))
        else:
            out[prefix + k] = v
    return out


def make_model(cfg: ModelConfig, device="cuda", use_kernel=False) -> Model:
    return Model(cfg, device, use_kernel)
