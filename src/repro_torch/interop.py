"""Carrying data between the reference package and the port.

The data plane's state is the bound data.  Both packages bind sources as
`{source: RecordBatch}` and a `RecordBatch` holds numpy columns, so numpy
dictionaries are the common currency.  `bindings` turns
`{source: {field: np.ndarray}}` (what the reference's
`RecordBatch.columns` hold) into the port's bindings; `columns` turns a
port result — a `RecordBatch` or a device-resident `MaskedBatch` — back
into `{field: np.ndarray}` of its valid rows.

The model plane's state is its weights: `model_params` turns the
reference's parameter pytree, as nested dicts of numpy arrays, into a
state dict for the port's `Model`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.masked import MaskedBatch
from .core.record import RecordBatch, as_numpy


def bindings(data: Mapping[str, Mapping[str, np.ndarray]]
             ) -> dict[str, RecordBatch]:
    """`{source: {field: array}}` -> the port's `{source: RecordBatch}`
    (columns copied, so later edits of `data` do not leak in)."""
    return {src: RecordBatch({f: np.array(v, copy=True)
                              for f, v in cols.items()})
            for src, cols in data.items()}


def columns(result) -> dict[str, np.ndarray]:
    """The valid rows of a port result as `{field: np.ndarray}`."""
    if isinstance(result, MaskedBatch):
        result = result.to_record_batch()
    b = result.to_numpy().compact()
    return {f: as_numpy(v) for f, v in b.columns.items()}


def model_params(params: Mapping, cfg) -> dict[str, torch.Tensor]:
    """The reference's parameter pytree (nested dicts of numpy arrays) ->
    `{dotted path: tensor}` for `Model.load_params`.  Dense, moe, vlm and
    rwkv6 trees stack each leaf under "layers" on a leading axis of
    `cfg.n_layers`, unstacked here into `layers.{i}.…`; the encdec tree
    stacks "enc_layers" on `cfg.n_enc_layers` and "dec_layers" on
    `cfg.n_layers`, unstacked alike.  The hybrid tree has "super", one
    dict per kind of `block_pattern` with each leaf stacked on the number
    of super-blocks, and "tail", a list of unstacked dicts: super-block s,
    kind j becomes layer `s·len(block_pattern) + j` and tail item i the
    layer after all super-blocks' plus i.  Every other leaf keeps its
    path, top-level arrays (`img_proj`, `enc_pos`, `dec_pos`) included."""
    out: dict[str, torch.Tensor] = {}
    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
              "dec_layers": cfg.n_layers}

    def leaf(v):
        return torch.from_numpy(np.array(v, copy=True))

    def walk(prefix: str, tree: Mapping, layer=None):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(f"{prefix}{k}.", v, layer)
            else:
                out[prefix + k] = leaf(v if layer is None else v[layer])

    for k, v in params.items():
        if k in stacks:
            for i in range(stacks[k]):
                walk(f"{k}.{i}.", v, i)
        elif k == "super":
            width = len(cfg.block_pattern)
            for j, kind in enumerate(v):
                for s in range(cfg.n_layers // width):
                    walk(f"layers.{s * width + j}.", kind, s)
        elif k == "tail":
            first = cfg.n_layers - len(v)
            for i, sub in enumerate(v):
                walk(f"layers.{first + i}.", sub)
        elif isinstance(v, Mapping):
            walk(f"{k}.", v)
        else:
            out[k] = leaf(v)
    return out
