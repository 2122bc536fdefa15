"""Sharding rules: FSDP + TP (+ EP/SP) parameter and activation layouts.

Port of `repro.parallel.sharding` onto `torch.distributed`: a
`DeviceMesh` with named dims stands for the reference's `Mesh`, and DTensor
placements for its `NamedSharding`.

Mesh convention (launch/mesh.py):
    single pod : (data=16, model=16)
    multi-pod  : (pod=2, data=16, model=16)
    one host   : (data=every rank of the process group)

Parameters are FSDP-sharded over `data` and tensor-parallel over `model`;
they are replicated across `pod`.  Activations shard batch over (pod, data)
and heads/mlp/vocab over `model`.

A spec is the reference's `PartitionSpec` as a tuple, one entry per tensor
dim: a mesh-axis name, a tuple of names (the dim split over those axes,
the first the major) or None.  `placements` turns a spec into DTensor
placements, one per mesh dim: a dim split over ("pod", "data") is
`Shard(d)` on both mesh dims, in the mesh's order, which is the
reference's major-to-minor order.  Where a function takes a mesh, a
mapping `{axis name: size}` also serves, for layouts that need no process
group.

Leaf names.  The reference matches a rule on the innermost string key of
a pytree path whose layer leaves are stacked on a leading axis (`[L, d,
f]` gets `(None, "data", "model")`).  The port's leaves are per layer,
under dotted paths (`layers.3.attn.wq`, `[d, f]`, gets `("data",
"model")`): the rule is that of the last dotted component that is not a
layer index, and a nested tree joins its keys with "." as well
(`mu.layers.3.attn.wq`).  A leaf without a rule above 4,000,000 elements
raises, as in the reference, counted on the port's per-layer leaf.

`logical_constraint` is the reference's `with_sharding_constraint`
against the ambient mesh, which here is the DTensor's own: a plain tensor
comes back as it is, and a DTensor is redistributed to the resolved
placements.  As in the reference, a hint never names an axis whose size
does not divide the dim, and a hint that resolves to no axis is none.
`torch.distributed.tensor` is imported only where a DTensor is made or
met (its import takes about a second), so the model's plain path never
loads it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Mapping, Sequence

import torch

# logical activation axis -> mesh axis (tuples = use both if present)
LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "seq": ("model",),          # sequence parallelism (long-context decode)
}

# ---------------------------------------------------------------------------
# Parameter layout rules (matched on the leaf's parameter name)
# ---------------------------------------------------------------------------
# rule = logical axes of the TRAILING dims (leading dims -> None)
PARAM_RULES: dict[str, tuple] = {
    # embeddings: [vocab, d_model]
    "table": ("vocab", "fsdp"),
    # attention projections
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    # dense mlp
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp"),
    # moe: stacked experts [E, d, f] / [E, f, d]; E unsharded (TP-in-expert:
    # expert counts 8/60 don't divide the 16-wide axis)
    "we_gate": (None, "fsdp", "tp"), "we_up": (None, "fsdp", "tp"),
    "we_down": (None, "tp", "fsdp"),
    "router": ("fsdp", None),
    # rwkv6 time-mix / channel-mix
    "w_r": ("fsdp", "tp"), "w_kk": ("fsdp", "tp"), "w_vv": ("fsdp", "tp"),
    "w_g": ("fsdp", "tp"), "w_o": ("tp", "fsdp"),
    "w_ck": ("fsdp", "tp"), "w_cv": ("tp", "fsdp"), "w_cr": ("fsdp", "tp"),
    # rg-lru block
    "w_x": ("fsdp", "tp"), "w_gate_rec": ("fsdp", "tp"), "w_out": ("tp", "fsdp"),
    "w_a": ("fsdp", None), "w_i": ("fsdp", None),
    # rwkv low-rank adapters (leading dims may be a mix index)
    "decay_lora_a": ("fsdp", None), "decay_lora_b": (None, "fsdp"),
    "mix_lora_a": ("fsdp", None), "mix_lora_b": (None, "fsdp"),
    # whisper positional tables, phi-3-vision projection
    "enc_pos": ("fsdp", None), "dec_pos": ("fsdp", None),
    "img_proj": ("fsdp", "tp"),
}

_AXIS_MAP = {"fsdp": "data", "tp": "model", "vocab": "model"}

# a leaf without a rule above this many elements raises
_RULELESS_MAX = 4_000_000


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout on a mesh, the reference's `NamedSharding(mesh, spec)`
    with the spec as DTensor placements (one per mesh dim)."""
    mesh: object
    placements: tuple


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` with named dims, or of a
    mapping that already is one."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _map(fn, tree, *others, path: str = ""):
    """`fn(dotted path, leaf, *the leaves at the same place in others)`
    over a tree of dicts and lists, in its structure."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, *(o[k] for o in others), path=f"{path}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(o[i] for o in others),
                               path=f"{path}{i}.")
                          for i, v in enumerate(tree))
    return fn(path[:-1], tree, *others)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def _resolve(axes: Sequence, mesh, shape) -> tuple:
    """Logical axes -> a spec on `mesh`: an axis the mesh lacks, or whose
    size does not divide the dim, is dropped."""
    sizes = mesh_sizes(mesh)
    spec = []
    for dim, a in zip(shape, axes):
        if a is None:
            spec.append(None)
            continue
        names = LOGICAL_RULES.get(a, (a,))
        live = tuple(n for n in names if n in sizes)
        total = math.prod(sizes[n] for n in live)
        if not live or dim % total != 0:  # never emit indivisible hints
            spec.append(None)
            continue
        spec.append(live if len(live) > 1 else live[0])
    return tuple(spec)


def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor.  None can exist before
    `torch.distributed.tensor` is imported, so until then this imports
    nothing."""
    if type(x) is torch.Tensor:  # the plain path: one type check
        return False
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def logical_constraint(x, axes: Sequence):
    """The reference's sharding hint: a DTensor is redistributed to the
    placements `axes` resolve to on its mesh; anything else is returned
    as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = _resolve(axes, mesh, x.shape)
    if all(s is None for s in spec):
        return x
    return x.redistribute(mesh, placements(spec, mesh))


def placements(spec: Sequence, mesh) -> tuple:
    """A spec -> DTensor placements, one per mesh dim.  Raises ValueError
    for a mesh axis named twice or a tuple entry not in the mesh's order
    (DTensor splits a dim over mesh dims in their order only)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a)
               for a in (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: {entry} is not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {tuple(spec)} names mesh axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _leaf_name(path: str):
    return next((p for p in reversed(path.split(".")) if not p.isdigit()),
                None)


def param_pspec(name: str, shape) -> tuple:
    """The rule's spec of the leaf at dotted path `name` with `shape`: the
    rule of its last non-index component, cut from the left to the leaf's
    dims or padded with None on the left; all None without a rule."""
    rule = PARAM_RULES.get(_leaf_name(name))
    ndim = len(shape)
    if rule is None:
        if math.prod(shape) > _RULELESS_MAX:
            raise ValueError(f"no sharding rule for large param {name} "
                             f"shape={tuple(shape)}")
        return (None,) * ndim
    rule = rule[-ndim:] if len(rule) >= ndim else rule
    return (None,) * (ndim - len(rule)) + tuple(
        _AXIS_MAP.get(a, a) if a is not None else None for a in rule)


def params_pspecs(params) -> dict:
    """The spec tree of a tree of tensors (or anything with a shape)."""
    return _map(lambda p, leaf: param_pspec(p, leaf.shape), params)


def validated_pspec(name: str, shape, mesh) -> tuple:
    """`param_pspec` on `mesh`: an axis the mesh lacks is dropped, and an
    entry whose axes' sizes do not divide the dim becomes None."""
    sizes = mesh_sizes(mesh)
    spec = param_pspec(name, shape)
    out = []
    for dim, ax in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axes = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                     if a in sizes)  # drop axes this mesh doesn't have
        if not axes or dim % math.prod(sizes[a] for a in axes) != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def validated_pspecs(params, mesh) -> dict:
    """Drop spec entries whose axis size doesn't divide the dim."""
    return _map(lambda p, leaf: validated_pspec(p, leaf.shape, mesh),
                params)


def named_shardings(tree, specs, mesh) -> dict:
    """The `NamedSharding` tree of a spec tree on `mesh`, walked in the
    structure of `tree` (whose leaves a spec's tuple would not be)."""
    return _map(lambda p, leaf, s: NamedSharding(mesh, placements(s, mesh)),
                tree, specs)


def params_sharding(params, mesh) -> dict:
    """The `NamedSharding` tree of `validated_pspecs` on `mesh`."""
    return named_shardings(params, validated_pspecs(params, mesh), mesh)


def batch_pspec(mesh) -> tuple:
    """The batch dim's spec: split over (pod, data) where the mesh has
    them."""
    axes = tuple(a for a in ("pod", "data") if a in mesh_sizes(mesh))
    return (axes if len(axes) > 1 else (axes[0] if axes else None),)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
def _holds_dtensor(tree) -> bool:
    """Whether a tree of tensors holds a DTensor (its first leaf does)."""
    while isinstance(tree, (Mapping, list, tuple)):
        if not tree:
            return False
        tree = next(iter(tree.values())) if isinstance(tree, Mapping) \
            else tree[0]
    return is_dtensor(tree)


def full_tensor(x):
    """The whole of a DTensor as a plain tensor (a collective where it is
    sharded or partial); any other value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def gather_rows(table, idx):
    """`table[idx]` (rows of `table` picked by an integer tensor).  On a
    DTensor table each rank picks from the whole table by its own slice of
    `idx` with the plain op, and the result is laid out as `idx` (a plain
    `idx` counts as replicated): on one rank that gives the plain path's
    bits, forward and backward.  (torch 2.11's sharding rule for the
    backward of `table[idx]`, `index_put`, fails on a batch-sharded index.)
    The table's gradient is a partial sum over the mesh dims that split
    `idx`, reduced to the table's placement."""
    if not is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    if is_dtensor(idx):
        place, local = tuple(idx.placements), idx.to_local()
    else:
        place, local = (Replicate(),) * mesh.ndim, idx
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate()
                         for p in place])
    shape = tuple(idx.shape) + tuple(table.shape[1:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(whole[local], mesh, place, run_check=False,
                              shape=shape, stride=stride)


def gather_fsdp(tree):
    """A parameter tree with each DTensor leaf made whole over the batch
    mesh axes ("pod", "data"), which split the parameters FSDP-style,
    and kept split over "model": the gather before use that the
    reference's partitioner inserts where a weight meets batch-split
    activations (its gradient comes back reduce-scattered).  A tree
    without DTensors comes back as it is."""
    if not _holds_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate

    def one(path, x):
        if not is_dtensor(x):
            return x
        names = x.device_mesh.mesh_dim_names
        place = [Replicate() if names[i] in ("pod", "data") else p
                 for i, p in enumerate(x.placements)]
        if place == list(x.placements):
            return x
        return x.redistribute(x.device_mesh, place)

    return _map(one, tree)


def grad_as_value(x):
    """`x` as it is, with its gradient laid out as `x` is: a DTensor
    passes through `to_local` / `from_local`, whose backward redistributes
    the gradient to `x`'s placements, so the op that made `x` never meets
    a gradient laid out otherwise (one split over heads or rows its
    backward cannot split back).  Anything else is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def dense(x, w):
    """`x @ w` for x [..., d] and a weight w [d, f].  On a DTensor it is
    the fold torch.matmul makes (the leading dims into one, one mm,
    unfolded) with two guards for batch rows the mesh does not divide:
    the folded x's gradient is laid out as the folded x (`grad_as_value`)
    and the unfold goes through `split_dim`, since DTensor may lay the
    product or its gradient out over the folded rows, which a view
    cannot split back.  A plain x takes `x @ w` as it is."""
    if not is_dtensor(x):
        return x @ w
    lead = tuple(x.shape[:-1])
    y = grad_as_value(x.reshape(-1, x.shape[-1])) @ w
    return split_dim(y, 0, *lead) if len(lead) > 1 else y


def merge_heads(o):
    """[B, H, T, D] -> [B, T, H·D], as `o.transpose(1, 2).reshape`, its
    gradient laid out as the output (`grad_as_value`): a gradient that the
    next product splits over H·D could not be split back into heads the
    mesh does not divide."""
    b, h, t, d = o.shape
    return grad_as_value(o.transpose(1, 2).reshape(b, t, h * d))


def split_dim(x, dim: int, *sizes):
    """`x` with dim `dim` split into `sizes` ([..., a*b, ...] -> [...,
    a, b, ...], a view where it can be).  A DTensor split on that dim
    over mesh dims whose sizes do not divide `a` is first made whole on
    those mesh dims (DTensor carries a dim's shards to the first part
    only, and only evenly): the reference's 8 kv heads over a 16-wide
    `model` axis.  A plain tensor is reshaped as it is."""
    dim %= x.ndim
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        on = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
        mesh = x.device_mesh
        if on and sizes[0] % math.prod(mesh.size(i) for i in on):
            x = x.redistribute(mesh, [Replicate() if i in on else p
                                      for i, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def heads_local(fn, q, k, v, **kw):
    """`fn(q, k, v, **kw)` for attention over q [B, Hq, T, D] and k / v
    [B, Hkv, S, D], `fn` one of the plain functions of `kernels.ref`,
    which take k and v to float32 and repeat them to the query heads.  On
    DTensors each rank runs `fn` on its own batch rows and query heads: k
    and v are taken to float32 and repeated to the query heads here (GQA;
    `fn` then repeats each head once), all three are laid out as q on the
    batch and head dims and made whole on the others, and the output [B,
    Hq, T, Dv] keeps that layout.  (Run as DTensor ops, the products'
    flattening of (batch, heads) into one dim gathers the heads on every
    rank.)  With `ref.attention` the arithmetic is the plain call's,
    forward and backward: the repeated heads' gradients are summed in
    float32 before the cast back (`ref.blocked_attention` sums its key
    blocks' gradients in float32 here, in the activation dtype there).
    Plain tensors go to `fn` as they are."""
    if not is_dtensor(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = q.device_mesh
    place = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
             for p in q.placements]
    group = q.shape[1] // k.shape[1]
    q, k, v = (x.redistribute(mesh, place) for x in (
        q, k.float().repeat_interleave(group, dim=1),
        v.float().repeat_interleave(group, dim=1)))
    out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    shape = tuple(q.shape[:3]) + (v.shape[3],)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(4))
    return DTensor.from_local(out, mesh, place, run_check=False,
                              shape=shape, stride=stride)


def replicated(x):
    """A DTensor whole on every rank (redistributed to Replicate), as a
    view that merges a split dim needs it on torch 2.11 (the MoE's [E,
    cap, D] -> [E*cap, D]); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def placed_as(x, like):
    """`x` laid out as the DTensor `like` (a gradient as its parameter:
    a partial sum is reduced, scattered where the parameter is sharded);
    `x` itself where `like` is no DTensor or `x` is laid out so."""
    if not is_dtensor(like) or tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


@contextlib.contextmanager
def plain_as_replicated(tree):
    """Where `tree` holds a DTensor: inside, a plain tensor that meets a
    DTensor in an op counts as replicated on its mesh (torch's
    `implicit_replication`; the autograd engine carries the setting into
    the backward).  The model's own tensors — positions, masks, rope
    frequencies, seeded noise — are the same on every rank, so that is
    what they are.  Nesting keeps the outer setting."""
    if not _holds_dtensor(tree):
        yield
        return
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    was = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = was


_RULES_FILLED: list = []


def _fill_rule_gaps() -> None:
    """Register, once, the sharding rule torch 2.11's DTensor lacks for
    `flip` (the backward of `cumsum`, which the rwkv6 recurrence runs): a
    flipped dim must be whole.  A torch that has its own rule keeps it."""
    if _RULES_FILLED:
        return
    _RULES_FILLED.append(True)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    prop = DTensor._op_dispatcher.sharding_propagator
    flip = torch.ops.aten.flip.default
    if any(flip in getattr(prop, table, {}) for table in (
            "op_strategy_funcs", "op_single_dim_strategy_funcs",
            "op_to_rules")):
        return

    @register_sharding(flip)
    def _flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None])
            for d in range(x.ndim) if d not in flipped]


def shard(x, sharding: NamedSharding):
    """A full tensor, the same on every rank, as a DTensor laid out by
    `sharding`: each rank keeps its own slice, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    _fill_rule_gaps()
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def place_params(params, mesh) -> dict:
    """A tree of full tensors (a flat `{dotted path: tensor}` dict or
    nested dicts of them), the same on every rank, placed on `mesh` by
    `validated_pspecs`."""
    return _map(lambda p, x, s: shard(x, s), params,
                params_sharding(params, mesh))


def place_batch(batch: Mapping, mesh) -> dict:
    """A batch of full tensors, the same on every rank, each split on its
    leading dim by `batch_pspec`."""
    spec = batch_pspec(mesh)
    return {k: shard(v, NamedSharding(
        mesh, placements(spec + (None,) * (v.dim() - 1), mesh)))
        for k, v in batch.items()}
