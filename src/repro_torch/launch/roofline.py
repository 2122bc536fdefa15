"""Roofline analysis of one counted run of a placed step (no hardware
needed).

Port of `repro.launch.roofline`.  Three terms per (arch × shape × mesh),
in seconds:

    compute    = FLOPs_per_device / peak_bf16_FLOPs_per_chip
    memory     = bytes_per_device / HBM_bandwidth_per_chip
    collective = collective_bytes_per_device / link_bandwidth

The reference reads them from XLA (`cost_analysis()` of the per-device
SPMD program, the optimized HLO's collectives, `memory_analysis()`).
Here one `StepCounter` — a dispatch mode — watches a single run of the
step on meta tensors placed as DTensors on the cell's mesh, and counts
on each rank's LOCAL shards, as the reference's per-device program does:

- FLOPs with `torch.utils.flop_counter`'s formulas, op for op as
  `FlopCounterMode` counts them (the same decompositions first);
- bytes as eager torch moves them: each op that is not a view reads its
  tensor inputs once and writes its outputs once (nothing is fused);
- collectives: the RESULT bytes of every `_c10d_functional` collective
  DTensor issues, keyed by the reference's HLO kind names (its
  result-shape convention);
- memory: the bytes of every live storage, followed op by op through a
  weak reference on each storage (a storage dies with its last tensor),
  from which `memory_summary` gives the reference's four keys.

A DTensor op is handed back to DTensor (`NotImplemented`), whose local
ops and collectives then come through the mode; the ops DTensor's
sharding propagation runs on fake tensors to learn output shapes are not
counted.  `Roofline.chip` defaults to the card's data sheet
(`hw.H100_SXM`); `hw.CHIP` stays the reference's TPU for the planner.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) gives the useful-compute
ratio that catches remat/redundancy waste.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from .. import hw

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "collective-broadcast")

# torch dtype -> the HLO element type the reference's table is keyed by
_HLO_TYPE = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint64: "u64",
    torch.uint32: "u32", torch.uint16: "u16", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

# `_c10d_functional` collective (its in-place and coalesced forms too) ->
# the reference's kind
_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's elements (the reference's `_shape_bytes`)."""
    return t.numel() * _DTYPE_BYTES[_HLO_TYPE[t.dtype]]


def _tensors(tree):
    """The tensors of a nest of lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def local_bytes(tree) -> int:
    """Bytes of the distinct local shards of a tree of (D)tensors (a
    DTensor's shard, which may view a larger storage, counts its own
    elements)."""
    seen = {}
    for t in _tensors(tree):
        loc = _local(t)
        key = (loc.untyped_storage()._cdata, loc.storage_offset(),
               tuple(loc.shape))
        seen[key] = tensor_bytes(loc)
    return sum(seen.values())


def _collective_kind(func):
    ns, _, name = func._schema.name.partition("::")
    if ns not in ("_c10d_functional", "c10d_functional"):
        return None
    return _KIND.get(name.rstrip("_"))


class StepCounter(TorchDispatchMode):
    """Per-device counts of everything run while the mode is active:
    `flops`, `hbm` (bytes each non-view op reads and writes), `coll`
    ({kind: result bytes}), and live storage bytes (`live`, `peak`).

    Storages that exist before the mode is entered are not followed:
    the caller counts them as arguments (`argument_bytes`)."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor

        self._dtensor, self._fake = DTensor, FakeTensorMode
        self.flops = 0
        self.hbm = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._owned: dict = {}   # storage key -> bytes, while alive
        self._external: set = set()   # the arguments' storages

    # -- memory --------------------------------------------------------------
    def _free(self, key):
        self.live -= self._owned.pop(key)

    def _follow(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._owned or key in self._external:
            return
        n = st.nbytes()
        self._owned[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def argument_bytes(self, tree) -> int:
        """`local_bytes(tree)`; the storages of `tree` are never counted
        as made by the run."""
        self._external.update(
            _local(t).untyped_storage()._cdata for t in _tensors(tree))
        return local_bytes(tree)

    # -- dispatch -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            # DTensor runs the op: its local ops come back through here
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator) or any(
                isinstance(m, self._fake)
                for m in _get_current_dispatch_mode_stack()):
            # sharding propagation on fake tensors: shapes, not work
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default:
            # as FlopCounterMode: an op that decomposes is counted by parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = list(_tensors(out))
        kind = _collective_kind(func)
        if kind is not None:
            self.coll[kind] += sum(tensor_bytes(t) for t in outs)
        rets = func._schema.returns
        aliases = bool(rets) and all(r.alias_info is not None for r in rets)
        views = aliases and not any(r.alias_info.is_write for r in rets)
        if kind is None and not views:
            self.hbm += sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
            self.hbm += sum(tensor_bytes(t) for t in outs)
        if not aliases:   # a view or an in-place op allocates nothing
            for t in outs:
                self._follow(t)

    def counts(self) -> dict:
        """{"flops", "hbm", "coll": {kind: bytes} without the zero kinds}."""
        return {"flops": float(self.flops), "hbm": float(self.hbm),
                "coll": {k: v for k, v in self.coll.items() if v}}


@dataclasses.dataclass
class Roofline:
    flops: float                    # per-device flops
    hbm_bytes: float                # per-device bytes accessed
    coll_bytes: float               # per-device collective bytes
    coll_by_kind: dict
    model_flops: float              # 6 N D (global)
    chips: int
    chip: hw.ChipSpec = hw.H100_SXM

    @property
    def t_compute(self) -> float:
        return self.flops / self.chip.peak_bf16_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.chip.hbm_bandwidth

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.chip.ici_link_bandwidth

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (global flops)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term bound that useful compute achieves:
        (MODEL_FLOPS / chips / peak) / max(term)."""
        t_useful = self.model_flops / self.chips / self.chip.peak_bf16_flops
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_bound if t_bound else 0.0

    def row(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(counts: dict, model_flops: float, chips: int) -> Roofline:
    """A `Roofline` from `StepCounter.counts()` (or `dryrun._measure`)."""
    co = counts["coll"]
    return Roofline(flops=max(counts["flops"], 0.0),
                    hbm_bytes=max(counts["hbm"], 0.0),
                    coll_bytes=float(sum(co.values())), coll_by_kind=co,
                    model_flops=model_flops, chips=chips)


def model_flops_for(cfg, shape_kind: str, tokens: int) -> float:
    """6·N·D with N = active params for MoE; D = tokens processed.
    Training multiplies by 3 (fwd + bwd ≈ 2x fwd)."""
    n = cfg.active_param_count()
    mult = 3.0 if shape_kind == "train" else 1.0
    return 2.0 * n * tokens * mult


def memory_summary(counted) -> dict:
    """The reference's four keys from a counted run (`dryrun.Counted`):
    the arguments' local bytes, the outputs' bytes made by the run, the
    peak of the bytes the run itself held live (temp), and peak = temp +
    argument, since the arguments stay live across the run."""
    return {
        "argument_bytes": int(counted.argument_bytes),
        "output_bytes": int(counted.output_bytes),
        "temp_bytes": int(counted.temp_bytes),
        "peak_bytes": int(counted.temp_bytes) + int(counted.argument_bytes),
    }
