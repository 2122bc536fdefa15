"""Sharded flow execution on a single-controller mesh (the Nephele-engine
analogue).

Port of `repro.core.distributed`.  The reference runs a physical plan
(`physical.PhysPlan`) data-parallel under `shard_map` over the mesh `data`
axis; here ONE process drives every shard, as one JAX program drives a
`shard_map`:

* a shard is a per-shard `MaskedBatch` on a device (`ShardMesh`: shard i on
  `devices[i % len(devices)]`; on one card every shard sits on it, on the
  CPU on `cpu`);
* a collective is a tensor operation over the list of shards;
* the per-shard walk runs in lockstep: each route entry runs on every
  shard before the next entry, because a collective needs every shard's
  upstream output.

The per-shard walk executes the SAME fused stages as the local compiled
pipeline — Map chains fuse, megakernel spans compact interior boundaries
with `span_compact` / `span_segment` (DESIGN.md §10), combiner halves of a
split Reduce pre-aggregate per shard BEFORE any collective fires — so under
`use_kernels=True` on CUDA tensors every stage launches the repo's kernels
exactly as `pipeline.CompiledPlan` does.  The adaptive side-channel sums
every stage's boundary counts over the shards, so one global observation
per batch feeds the §9 feedback loop.  The paper's shipping strategies map
onto collectives:

    partition  -> hash repartition (the reference's all_to_all), on the
                  partition columns the optimizer chose (`Stage.ship_keys`)
    broadcast  -> replicate (the reference's tiled all_gather)
    forward    -> no communication (the plan proved co-location)

Micro-batched wire (DESIGN.md §12): with K > 1 slices each collective's
payload is bit-packed into one lane matrix and shipped in K slices over
disjoint slot ranges (`REPRO_OVERLAP_SLICES`, kill switch
`REPRO_OVERLAP=0`); the slices reassemble to EXACTLY the serial receive
layout, so both wires give bit-identical batches.  What every receiver
gets from a collective is the same payload (only its validity differs), so
the mesh builds that payload once per device and the receivers on a device
share it: a broadcast to p shards on one card holds one copy, not p.

Capacity management: a repartition expands each shard's buffer to p x its
capacity (one slot block per peer, peer-major) and compacts back with
`masked.compact_to_estimate(..., shards=p)`.  Every shard gets the same
planned capacity, so the global output is the shards' batches concatenated
shard-major, as `P(axis)` lays it out in the reference.  `bind_global`
runs the same hash on the host's copy of a source to honor
`Source.partitioned_on`.

Entry points: `execute_distributed` (one-shot; prices and plans routes per
call) and `DistributedPlan` (cached serving handle whose executable
identity includes the layout — ship strategies, partition columns, shard
count, slicing).  Every entry point runs on "cuda" unless given
`device="cpu"` or a `ShardMesh`.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from . import masked as M
from .operators import CoGroupOp, MatchOp, Node, ReduceOp, Source
from .physical import MESH_SHARDS_ENV, PhysPlan, default_mesh_shards
from .record import RecordBatch, resolve_device

_MIX = 0x9E3779B97F4A7C15  # Fibonacci hashing constant

# Collective/compute overlap knobs (DESIGN.md §12).  REPRO_OVERLAP=0 is the
# kill switch (forces the serial per-column wire); REPRO_OVERLAP_SLICES sets
# the slice count K (clamped to a divisor of the buffer capacity at the
# collective site, so slices stay equal-sized).
OVERLAP_ENV = "REPRO_OVERLAP"
OVERLAP_SLICES_ENV = "REPRO_OVERLAP_SLICES"
DEFAULT_OVERLAP_SLICES = 4


def overlap_slices_default() -> int:
    """Effective slice count from the environment (1 = overlap off)."""
    if os.environ.get(OVERLAP_ENV, "1") == "0":
        return 1
    try:
        k = int(os.environ.get(OVERLAP_SLICES_ENV,
                               str(DEFAULT_OVERLAP_SLICES)))
    except ValueError:
        return DEFAULT_OVERLAP_SLICES
    return max(k, 1)


class ShuffleStats:
    """Accounting of what crosses the shipping collectives.

    `wire_rows` counts buffer slots through a collective per plan execution
    (per-shard capacity x shards — the tensor rows on the wire, masked
    slots included); `wire_bytes` are those slots priced at the batch's
    per-row byte width (column itemsizes + 1 validity byte), so the §12
    comms cost model can be held against observed traffic.
    `collectives`/`broadcasts` count repartition/replication SITES (logical
    edges, independent of slicing); `dispatches` counts the transfers
    issued (serial: one per column + validity; sliced: one packed transfer
    per slice); `slices` sums the slice counts, so `1 - sites/slices` is
    the overlap fraction.  As in the reference, where the counting happens
    while the `shard_map` body is traced, a site is counted once per
    build: every `execute_distributed` call counts, a warm
    `DistributedPlan` step counts nothing."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.wire_rows = 0
        self.wire_bytes = 0
        self.collectives = 0
        self.broadcasts = 0
        self.dispatches = 0
        self.slices = 0

    @property
    def sites(self) -> int:
        return self.collectives + self.broadcasts

    def overlap_fraction(self) -> float:
        """Fraction of shipped slices that had an independent in-flight
        peer slice ((K-1)/K under uniform K-slicing; 0 when serial)."""
        if self.slices <= 0:
            return 0.0
        return 1.0 - self.sites / self.slices


_SHUFFLE_STATS = ShuffleStats()


def shuffle_stats() -> ShuffleStats:
    """Process-wide collective accounting (cleared by the caller)."""
    return _SHUFFLE_STATS


def _account(b: M.MaskedBatch, p: int, k: int, broadcast: bool) -> None:
    width = sum(v.element_size() for v in b.columns.values()) + 1
    s = _SHUFFLE_STATS
    s.wire_rows += b.capacity * p
    s.wire_bytes += b.capacity * p * width
    if broadcast:
        s.broadcasts += 1
    else:
        s.collectives += 1
    s.slices += k
    if k == 1:  # serial: one transfer per column, plus the validity mask
        s.dispatches += len(b.columns) + 1
    else:  # sliced: K packed transfers, validity rides as a payload lane
        s.dispatches += k


# ---------------------------------------------------------------------------
# The partition hash, in unsigned 64-bit arithmetic
#
# Torch has no general uint64 arithmetic, so an int64 tensor carries the
# uint64 bit pattern: a multiply's low 64 bits are the unsigned product's,
# a logical shift is an arithmetic shift with the sign bits masked off, and
# the unsigned remainder is taken from the pattern's upper 63 bits and its
# low bit.
# ---------------------------------------------------------------------------
def _signed(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


_MIX_S = _signed(_MIX)
_M1, _M2 = _signed(0xBF58476D1CE4E5B9), _signed(0x94D049BB133111EB)


def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of uint64 bits held in int64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _hash_u64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _srl(x, 30)) * _M1
    x = (x ^ _srl(x, 27)) * _M2
    return x ^ _srl(x, 31)


def _umod(x: torch.Tensor, p: int) -> torch.Tensor:
    """`x % p` of uint64 bits held in int64 (x = 2 (x >> 1) + (x & 1))."""
    return (_srl(x, 1) % p * 2 + (x & 1)) % p


def _u64_bits(v: torch.Tensor) -> torch.Tensor:
    """A key column as the bits of numpy's `astype(uint64)`, in int64:
    signed integers sign-extend, unsigned ones and bool zero-extend, uint64
    is its own pattern, floats truncate (numpy's cast for values in
    [0, 2**63))."""
    if v.dtype == torch.uint64:
        return v.view(torch.int64)
    return v.to(torch.int64)


def _key_hash(cols: Mapping, keys) -> torch.Tensor:
    first = cols[keys[0]]
    h = torch.zeros(first.shape[0], dtype=torch.int64, device=first.device)
    for k in keys:
        h = _hash_u64((h * _MIX_S) ^ _u64_bits(cols[k]))
    return h


def _target(cols: Mapping, keys, p: int) -> torch.Tensor:
    """Each row's destination shard, int64 in [0, p)."""
    return _umod(_key_hash(cols, keys), p)


# ---------------------------------------------------------------------------
# Lane packing for sliced collectives
#
# All columns (plus the validity mask) are bitcast into one matrix of
# uint64 lanes (held in int64) of shape [lanes, capacity], so each slice
# ships as ONE transfer whatever the column count.  8-byte dtypes bitcast to
# one lane; narrower dtypes zero-extend into a lane through a same-width
# integer view and a mask, and unpack by viewing the lane's low bytes
# (little-endian, as on x86 and the GPU) — no value cast either way, so
# NaN payloads, -0.0 and bool round-trip bit for bit, and the reassembly
# below is a pure concat/reshape back to the serial receive layout.
# ---------------------------------------------------------------------------
_INT_OF = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _lane_rows(v: torch.Tensor) -> torch.Tensor:
    """[capacity] column -> [lanes, capacity] int64 lanes (bit-exact)."""
    if v.dtype == torch.bool:
        return v.to(torch.int64)[None, :]
    size = v.element_size()
    if size < 8:
        u = v.view(_INT_OF[size]).to(torch.int64) & ((1 << 8 * size) - 1)
        return u[None, :]
    u = v.view(torch.int64)
    return u[None, :] if u.ndim == 1 else u.T


def _from_lane_rows(rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `_lane_rows`: [lanes, n] int64 -> [n] of `dtype`."""
    if dtype == torch.bool:
        return rows[0] != 0
    size = torch.empty((), dtype=dtype).element_size()
    if size < 8:
        low = rows[0].contiguous().view(_INT_OF[size]).reshape(-1, 8 // size)
        return low[:, 0].contiguous().view(dtype)
    if rows.shape[0] == 1:
        return rows[0].contiguous().view(dtype)
    return rows.T.contiguous().view(dtype)


def _pack_payload(cols: Mapping):
    """Pack columns into one int64 [lanes, capacity] lane matrix."""
    rows, meta = [], []
    for f, v in cols.items():
        r = _lane_rows(v)
        rows.append(r)
        meta.append((f, v.dtype, r.shape[0]))
    return torch.cat(rows, dim=0), meta


def _unpack_payload(buf: torch.Tensor, meta) -> dict:
    cols, off = {}, 0
    for f, dt, m in meta:
        cols[f] = _from_lane_rows(buf[off:off + m], dt)
        off += m
    return cols


def _unpack_slices(recv: Sequence[torch.Tensor], meta) -> dict:
    """Reassemble K gathered slices ([W, p, cs] each, disjoint slot ranges)
    into columns in the serial receive layout ([p*cap], peer-major).  One
    concat per column — no full-payload transpose — because slice j holds
    slot range [j*cs, (j+1)*cs) of every peer's block."""
    cols, off = {}, 0
    for f, dt, m in meta:
        lane = torch.cat([r[off:off + m] for r in recv], dim=2)
        cols[f] = _from_lane_rows(lane.reshape(m, -1), dt)
        off += m
    return cols


def _slice_count(capacity: int, slices: int) -> int:
    """Largest divisor of `capacity` not exceeding the requested count
    (capacities are 8·2^k buckets, so 2/4/8 divide whenever cap >= 8)."""
    k = max(1, min(int(slices), capacity))
    while capacity % k:
        k -= 1
    return k


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------
class ShardMesh:
    """`p` shards over `devices`: shard i lives on `devices[i % len]`.

    The port's stand-in for `jax.sharding.Mesh` on the `data` axis.  Shards
    may outnumber devices (virtual shards: 8 shards on one card run the
    8-way plan's per-shard walk and collectives on that card)."""

    def __init__(self, p: int, devices: Sequence = ("cuda",)):
        if int(p) < 1 or not devices:
            raise ValueError(f"a mesh needs p >= 1 and a device, got {p}, "
                             f"{devices}")
        self.p = int(p)
        self.devices = tuple(resolve_device(d) for d in devices)

    def device_of(self, i: int) -> torch.device:
        return self.devices[i % len(self.devices)]


def _default_mesh(mesh: Optional[ShardMesh], mesh_shards: Optional[int],
                  device) -> ShardMesh:
    """The caller's mesh, else `mesh_shards` shards over `device` ("cuda"
    names every card, "cuda:i" one; "cpu" the host).  The default width is
    every device, narrowed by `REPRO_MESH_SHARDS` when set; an explicit
    `mesh_shards` is taken as given, virtual shards included."""
    if mesh is not None:
        return mesh
    want = torch.device(device)
    first = resolve_device(want)
    if want.type == "cuda" and want.index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [first]
    if mesh_shards is None:
        mesh_shards = default_mesh_shards(len(devs)) \
            if MESH_SHARDS_ENV in os.environ else len(devs)
    return ShardMesh(max(1, int(mesh_shards)), devs)


def _shards(mesh: ShardMesh, b: M.MaskedBatch) -> list:
    """A global batch (p-divisible capacity) as its p per-shard blocks;
    views of it for the shards on its own device."""
    per = b.capacity // mesh.p
    out = []
    for i in range(mesh.p):
        d = mesh.device_of(i)
        sl = slice(i * per, (i + 1) * per)
        out.append(M.MaskedBatch(
            {f: v[sl].to(d) for f, v in b.columns.items()},
            b.valid[sl].to(d)))
    return out


def _to_shards(mesh: ShardMesh, t: torch.Tensor) -> list:
    """One received tensor on every shard's device, a copy per device."""
    per_dev: dict = {}
    return [per_dev.setdefault(mesh.device_of(i), t.to(mesh.device_of(i)))
            for i in range(mesh.p)]


def _gather(bs: Sequence[M.MaskedBatch], home: torch.device) -> M.MaskedBatch:
    """The shards' batches concatenated shard-major on `home` (the global
    output, laid out as `P(axis)` lays it out; concatenated shards carry
    no order)."""
    cols = {f: torch.cat([b.columns[f].to(home) for b in bs])
            for f in bs[0].columns}
    return M.MaskedBatch(cols, torch.cat([b.valid.to(home) for b in bs]))


# ---------------------------------------------------------------------------
# Collective shipping, over the list of shards
# ---------------------------------------------------------------------------
def _receive(bs: Sequence[M.MaskedBatch], mesh: ShardMesh, k: int):
    """What every peer receives when each shard ships all of its slots:
    (columns, validity) in the serial receive layout ([p*cap], peer-major)
    on the first shard's device.  Serial (k == 1): one transfer per column
    plus the validity; sliced: the packed lane matrix (validity as its last
    lane) in k slot slices, reassembled per column."""
    home = bs[0].device
    if k == 1:
        cols = {f: torch.cat([b.columns[f].to(home) for b in bs])
                for f in bs[0].columns}
        return cols, torch.cat([b.valid.to(home) for b in bs])
    meta, bufs = None, []
    for b in bs:
        payload, meta = _pack_payload(b.columns)
        bufs.append(torch.cat([payload, b.valid.to(torch.int64)[None, :]]))
    cs = bs[0].capacity // k
    recv = [torch.stack([buf[:, j * cs:(j + 1) * cs].to(home)
                         for buf in bufs], dim=1)    # [W, p, cs]
            for j in range(k)]
    cols = _unpack_slices(recv, meta)
    valid = torch.cat([r[-1] for r in recv], dim=1).reshape(-1) != 0
    return cols, valid


def _repartition(bs: Sequence[M.MaskedBatch], keys, mesh: ShardMesh,
                 slices: int = 1, account: bool = True) -> list:
    """Hash-partition rows by key over the shards.

    Serial wire (`slices` 1): each sender hashes its rows and ships every
    column to every peer with a per-peer validity (the reference's
    all_to_all of the p-way replicated columns).  Sliced wire: the packed
    payload and the GLOBAL validity ship in K slices (the reference's
    tiled all_gathers) and each receiver re-hashes the received key columns
    and keeps its own rows.  The hash is a pure function of column values,
    so both wires give bit-identical batches."""
    p = mesh.p
    if p == 1:
        return list(bs)
    k = _slice_count(bs[0].capacity, slices)
    if account:
        _account(bs[0], p, k, broadcast=False)
    cols, valid = _receive(bs, mesh, k)
    if k == 1:
        home = valid.device
        tgts = [_target(b.columns, keys, p).to(home) for b in bs]
        valids = [torch.cat([b.valid.to(home) & (t == d)
                             for b, t in zip(bs, tgts)]) for d in range(p)]
    else:
        tgt = _target(cols, keys, p)
        valids = [valid & (tgt == d) for d in range(p)]
    per_col = {f: _to_shards(mesh, v) for f, v in cols.items()}
    return [M.MaskedBatch({f: per_col[f][d] for f in cols},
                          valids[d].to(mesh.device_of(d)))
            for d in range(p)]


def _broadcast(bs: Sequence[M.MaskedBatch], mesh: ShardMesh,
               slices: int = 1, account: bool = True) -> list:
    """Replicate all rows on every shard; sliced the same way as
    `_repartition`, with the same bit-identity guarantee.  Shards on one
    device share the replica."""
    p = mesh.p
    if p == 1:
        return list(bs)
    k = _slice_count(bs[0].capacity, slices)
    if account:
        _account(bs[0], p, k, broadcast=True)
    cols, valid = _receive(bs, mesh, k)
    per_col = {f: _to_shards(mesh, v) for f, v in cols.items()}
    per_valid = _to_shards(mesh, valid)
    return [M.MaskedBatch({f: per_col[f][d] for f in cols}, per_valid[d])
            for d in range(p)]


def _sum_over_shards(xs: Sequence, home: torch.device):
    """A count summed over the shards (the reference's psum)."""
    return torch.stack([torch.as_tensor(x).to(home).reshape(())
                        .to(torch.int64) for x in xs]).sum()


# ---------------------------------------------------------------------------
# Stage walking, in lockstep over the shards
#
# The plan is lowered once (host-side) through pipeline.lower_phys, so each
# shard executes the same fused stages as the local compiled pipeline;
# shipping collectives fire at stage inputs exactly where the physical plan
# placed them, hashing the partition columns the plan chose.
# ---------------------------------------------------------------------------
def _prepare(stages, root: Node, per_caps: Mapping[str, int], p: int,
             use_megakernel: bool) -> tuple:
    """What a build fixes: the stats memo priced at the GLOBAL scale of the
    bound batches (a shard holds capacity/p rows of each source) and the
    span routes, with collectives kept at solo-stage inputs
    (`require_forward`) so every shard runs the same span."""
    from ..kernels import megakernel as MK
    from .cost import seed_source_stats

    stats_memo = seed_source_stats(
        root, {n: c * p for n, c in per_caps.items()}, {})
    routes = None
    if use_megakernel and len(stages) >= 2:
        routes = MK.plan_routes(stages, dict(per_caps), require_forward=True)
    return stats_memo, routes


def _consumers(stages, entries) -> dict:
    """Stage index -> how many route entries read its output."""
    out: dict = {}
    for entry in entries:
        span = range(entry[1], entry[1] + 1) if entry[0] == "solo" \
            else range(entry[1], entry[2])
        for k in span:
            for ref in stages[k].inputs:
                if ref[0] == "stage" and ref[1] not in span:
                    out[ref[1]] = out.get(ref[1], 0) + 1
    return out


def _exec_stages(stages, shards: Mapping[str, list], mesh: ShardMesh,
                 use_kernels: bool, stats_memo: dict, slack: float,
                 routes: Optional[tuple], use_order: bool = True,
                 observe: Optional[list] = None,
                 overlap_slices: int = 1, account: bool = True) -> list:
    """Run the lowered stages on every shard; returns the last stage's
    per-shard outputs.  With `observe` a list, each stage appends its
    `(valid rows, aux)` summed over the shards (aux -1 for a stage without
    one), as the reference's psums do."""
    from . import pipeline as PL
    from ..kernels import megakernel as MK

    p = mesh.p
    home = mesh.devices[0]

    def compact(b: M.MaskedBatch, n: Node) -> M.MaskedBatch:
        return M.compact_to_estimate(b, n, stats_memo, slack, shards=p)

    entries = routes or tuple(("solo", i) for i in range(len(stages)))
    pending = _consumers(stages, entries)
    results: list = [None] * len(stages)

    def resolve(st, t, ref, how, order_t) -> list:
        node = st.top
        bs = shards[ref[1]] if ref[0] == "source" else results[ref[1]]
        if how == "forward":
            # only forwarded streams keep their per-shard order; the
            # collectives interleave rows and return order-free batches
            if use_order and order_t:
                bs = [b if b.order else b.with_order(order_t) for b in bs]
            return bs
        if how == "partition":
            # the optimizer's partition columns ride on Stage.ship_keys;
            # fall back to the operator key
            keys = None
            if st.ship_keys and len(st.ship_keys) > t:
                keys = st.ship_keys[t]
            if not keys:
                if isinstance(node, ReduceOp):
                    keys = node.key
                elif isinstance(node, (MatchOp, CoGroupOp)):
                    keys = node.left_key if t == 0 else node.right_key
                else:
                    raise ValueError(
                        f"partition ship on {type(node).__name__}")
            return [compact(b, st.input_plans[t].node) for b in
                    _repartition(bs, keys, mesh, overlap_slices, account)]
        if how == "broadcast":
            return _broadcast(bs, mesh, overlap_slices, account)
        raise ValueError(how)

    def release(lo: int, hi: int) -> None:
        # drop each upstream output once its last reader ran (the
        # reference keeps every stage's output until the walk ends; here
        # p shards' intermediates share one card)
        for k in range(lo, hi):
            for ref in stages[k].inputs:
                if ref[0] == "stage" and not lo <= ref[1] < hi:
                    pending[ref[1]] -= 1
                    if pending[ref[1]] == 0 and ref[1] != len(stages) - 1:
                        results[ref[1]] = None

    for entry in entries:
        if entry[0] == "solo":
            i = entry[1]
            st = stages[i]
            in_orders = st.in_orders or ((),) * len(st.inputs)
            ins = [resolve(st, t, ref, how, in_orders[t])
                   for t, (ref, how) in enumerate(zip(st.inputs, st.ship))]
            outs, counts, auxs, has_aux = [], [], [], False
            for s in range(p):
                obs: Optional[dict] = {} if observe is not None else None
                out = PL.execute_stage(st, [b[s] for b in ins], use_kernels,
                                       use_order, obs)
                if st.kind == "limit" and p > 1 and "broadcast" in st.ship:
                    # global WITH-TIES limit: the input was replicated, so
                    # every shard computed the IDENTICAL survivor mask on
                    # slot-aligned batches — per-slot ownership keeps the
                    # shards disjoint while their union is the one-shard
                    # result
                    own = (torch.arange(out.capacity, device=out.device)
                           % p) == s
                    out = M.MaskedBatch(dict(out.columns), out.valid & own,
                                        out.order)
                if observe is not None:
                    counts.append(out.valid.sum())
                    has_aux = "groups" in obs
                    auxs.append(obs.get("groups", -1))
                outs.append(compact(out, st.top))
            del ins
            if observe is not None:
                observe.append((_sum_over_shards(counts, home),
                                _sum_over_shards(auxs, home) if has_aux
                                else -1))
            results[i] = outs
            release(i, i + 1)
            continue
        _, i, j = entry
        span = stages[i:j]
        ins_per = []
        for k, st in enumerate(span):
            in_orders = st.in_orders or ((),) * len(st.inputs)
            ins_per.append([
                None if (ref == ("stage", i + k - 1) and k > 0)
                else resolve(st, t, ref, how, in_orders[t])
                for t, (ref, how) in enumerate(zip(st.inputs, st.ship))])
        planned = [M.planned_capacity(st.top, stats_memo, slack, shards=p)
                   for st in span]
        outs, span_obs = [], []
        for s in range(p):
            raw, obs_s, _ = MK.run_span(
                span, [[None if b is None else b[s] for b in row]
                       for row in ins_per], planned, use_kernels, use_order,
                observe=observe is not None)
            span_obs.append(obs_s)
            outs.append(compact(raw, span[-1].top))
        del ins_per
        if observe is not None:
            for k, has_aux in enumerate(MK.span_has_aux(span)):
                observe.append((
                    _sum_over_shards([o[k][0] for o in span_obs], home),
                    _sum_over_shards([o[k][1] for o in span_obs], home)
                    if has_aux else -1))
        results[j - 1] = outs
        release(i, j)
    return results[-1]


# ---------------------------------------------------------------------------
# Host-side source binding
# ---------------------------------------------------------------------------
def bind_global(root: Node, bindings: Mapping[str, RecordBatch], p: int,
                device="cuda") -> dict[str, M.MaskedBatch]:
    """Bind record batches to global mesh batches (p-divisible capacity) on
    `device`.

    Honors `Source.partitioned_on` by pre-hashing rows to shard blocks with
    the same hash the repartition uses; otherwise rows split into
    contiguous per-shard blocks.  Both layouts keep each shard a stable
    subsequence of the bound batch, so `Source.sorted_on` elisions stay
    sound on every shard."""
    device = resolve_device(device)
    sources = {n.name: n for n in root.iter_nodes()
               if isinstance(n, Source)}
    global_batches: dict[str, M.MaskedBatch] = {}
    for name, src in sources.items():
        b = bindings[name].to_numpy().compact().project(
            list(src.out_schema.fields))
        n = b.capacity
        per = int(np.ceil(max(n, 1) / p))
        cap = per * p
        if src.partitioned_on:
            tgt = _target({f: torch.from_numpy(np.asarray(b.columns[f]))
                           for f in src.partitioned_on},
                          src.partitioned_on, p).numpy()
            order = np.argsort(tgt, kind="stable")
            counts = np.bincount(tgt, minlength=p)
            if counts.max() > per:
                per = int(counts.max())
                cap = per * p
            cols, valid = {}, np.zeros(cap, bool)
            dest = np.concatenate(
                [np.arange(c) + t * per for t, c in enumerate(counts)]
            ).astype(np.int64)
            for f in b.fields:
                v = np.asarray(b.columns[f])
                arr = np.zeros((cap,) + v.shape[1:], dtype=v.dtype)
                arr[dest] = v[order]
                cols[f] = arr
            valid[dest] = True
        else:
            cols = {}
            for f, v in b.columns.items():
                v = np.asarray(v)
                cols[f] = np.concatenate(
                    [v, np.zeros((cap - n,) + v.shape[1:], dtype=v.dtype)])
            valid = np.arange(cap) < n
        global_batches[name] = M.MaskedBatch(
            {f: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for f, v in cols.items()},
            torch.from_numpy(valid).to(device))
    return global_batches


def _read_counts(vals: Sequence) -> np.ndarray:
    """Device scalars and host ints as one int64 vector on the host, read
    with one device-to-host copy."""
    out = np.asarray([v if isinstance(v, int) else -1 for v in vals],
                     dtype=np.int64)
    slots = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor)]
    if slots:
        out[slots] = torch.stack([vals[i] for i in slots]).cpu().numpy()
    return out


def _run(plan: PhysPlan, stages, staged: Mapping[str, M.MaskedBatch],
         mesh: ShardMesh, use_kernels: bool, slack: float, use_order: bool,
         observe: bool, overlap_slices: int, account: bool,
         prepared: tuple) -> tuple:
    """One step on global batches: split into shards, walk, concatenate.
    Returns `(global output, counts)`, counts the `[sources (name-sorted),
    per-stage rows, per-stage aux]` vector when observing, else None."""
    names = sorted(staged)
    local = {n: _shards(mesh, staged[n]) for n in names}
    obs: Optional[list] = [] if observe else None
    if not stages:
        out = local[plan.node.name]
    else:
        stats_memo, routes = prepared
        out = _exec_stages(stages, local, mesh, use_kernels, stats_memo,
                           slack, routes, use_order, obs, overlap_slices,
                           account)
    home = mesh.devices[0]
    out = _gather(out, home)
    if not observe:
        return out, None
    src = [_sum_over_shards([b.valid.sum() for b in local[n]], home)
           for n in names]
    return out, _read_counts(src + [o[0] for o in obs] + [o[1] for o in obs])


def _record(store, stages, names, counts) -> None:
    from . import pipeline as PL

    ns, nst = len(names), len(stages)
    PL.record_batch_obs(store, stages, dict(zip(names, counts[:ns])),
                        counts[ns:ns + nst], counts[ns + nst:ns + 2 * nst])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def execute_distributed(plan: PhysPlan, bindings: Mapping[str, RecordBatch],
                        mesh: Optional[ShardMesh] = None,
                        use_kernels: bool = False, slack: float = 4.0,
                        use_order: bool = True,
                        stats_store=None,
                        use_megakernel: Optional[bool] = None,
                        overlap_slices: Optional[int] = None,
                        mesh_shards: Optional[int] = None,
                        device="cuda") -> RecordBatch:
    """Execute a physical plan data-parallel over the mesh's shards
    (one-shot: prices capacities and plans routes per call, and counts the
    wire per call — long-lived callers want `DistributedPlan`).

    With `stats_store` (a `cost.StatsStore`), every stage's GLOBAL boundary
    counts — per-shard observations summed over the shards — are folded
    into the store, feeding the calibration loop the local serving handle
    uses (DESIGN.md §9).

    `overlap_slices` (default: `REPRO_OVERLAP_SLICES`, kill switch
    `REPRO_OVERLAP=0`) slices every collective into K transfers,
    bit-identical to the serial wire; `mesh_shards` sets the shard count
    when no `mesh` is given (default: every device of `device`, or
    `REPRO_MESH_SHARDS` when set)."""
    from . import pipeline as PL

    mesh = _default_mesh(mesh, mesh_shards, device)
    if overlap_slices is None:
        overlap_slices = overlap_slices_default()
    if use_megakernel is None:
        use_megakernel = PL._megakernel_default()
    staged = bind_global(plan.node, bindings, mesh.p, mesh.devices[0])
    stages = PL.lower_phys(plan)
    prepared = _prepare(stages, plan.node,
                        {n: b.capacity // mesh.p for n, b in staged.items()},
                        mesh.p, use_megakernel)
    out, counts = _run(plan, stages, staged, mesh, use_kernels, slack,
                       use_order, stats_store is not None, overlap_slices,
                       True, prepared)
    if stats_store is not None:
        _record(stats_store, stages, sorted(staged), counts)
    return out.to_record_batch()


class DistributedPlan:
    """Cached distributed serving handle (mesh analogue of
    `pipeline.CompiledPlan`).

    Lowers the physical plan once, then builds one executable per (layout,
    source signature, observe) key in a shared `pipeline.ExecutableCache` —
    the layout (per-stage ship strategies and partition columns via
    `pipeline._order_sig`, the shard count `p`, the mesh's devices, the
    overlap slice count, megakernel routing, `use_kernels`, `slack`,
    `use_order`) joins the executable identity, so plans that differ only
    in wire choices or devices never alias and warm serving never rebuilds.
    A build fixes the capacities' pricing and the span routes; its first
    step counts the wire (`shuffle_stats`), as the reference's trace does.
    The executable takes the mesh per call and keeps no handle, so handles
    sharing a cache never run on each other's mesh.

    `run(bindings)` host-binds then executes; `run_device(staged)` is the
    mesh serving path for batches already bound via `bind` (device-resident
    across calls, no host round-trip)."""

    def __init__(self, plan, mesh: Optional[ShardMesh] = None,
                 mesh_shards: Optional[int] = None,
                 overlap_slices: Optional[int] = None,
                 use_kernels: bool = False, slack: float = 4.0,
                 use_order: bool = True,
                 use_megakernel: Optional[bool] = None, cache=None,
                 device="cuda"):
        from . import pipeline as PL

        plan = getattr(plan, "best", plan)   # OptResult
        plan = getattr(plan, "plan", plan)   # RankedPlan
        if not isinstance(plan, PhysPlan):
            raise TypeError(f"expected a PhysPlan, got {type(plan).__name__}")
        self.plan = plan
        self.mesh = _default_mesh(mesh, mesh_shards, device)
        self.p = self.mesh.p
        self.overlap_slices = overlap_slices_default() \
            if overlap_slices is None else max(1, int(overlap_slices))
        self.use_kernels = use_kernels
        self.slack = float(slack)
        self.use_order = use_order
        self.use_megakernel = PL._megakernel_default() \
            if use_megakernel is None else use_megakernel
        self.cache = cache if cache is not None else PL.executable_cache()
        self.stages = PL.lower_phys(plan)
        self._sem = PL._Interned((
            PL.semantic_key(plan.node), PL._order_sig(self.stages), self.p,
            tuple(str(d) for d in self.mesh.devices), self.overlap_slices,
            self.use_megakernel, self.use_kernels, self.slack,
            self.use_order))
        self._sources = sorted(n.name for n in plan.node.iter_nodes()
                               if isinstance(n, Source))
        self._last_routes: Optional[tuple] = None

    # -- binding ---------------------------------------------------------
    def bind(self, bindings: Mapping[str, RecordBatch]) -> dict:
        """Host-bind a request to global mesh batches on the mesh's first
        device (reusable across `run_device` calls)."""
        return bind_global(self.plan.node, bindings, self.p,
                           self.mesh.devices[0])

    def _source_sig(self, staged: Mapping[str, M.MaskedBatch]) -> tuple:
        home = self.mesh.devices[0]
        for n in self._sources:
            if n not in staged:
                raise KeyError(f"no binding for source {n!r}")
            b = staged[n]
            if b.device != home:
                raise ValueError(f"source {n!r} is bound on {b.device}, "
                                 f"the mesh's batches live on {home}")
            if b.capacity % self.p:
                raise ValueError(f"source {n!r} has capacity {b.capacity}, "
                                 f"not divisible by {self.p} shards")
        return tuple(
            (n, staged[n].capacity,
             tuple((f, str(v.dtype))
                   for f, v in staged[n].columns.items()))
            for n in self._sources)

    # -- execution -------------------------------------------------------
    def _executable(self, staged: Mapping[str, M.MaskedBatch],
                    observe: bool):
        sig = self._source_sig(staged)
        key = (self._sem, sig, observe)
        fn = self.cache.get(key)
        if fn is not None:
            return fn
        self.cache.count_trace()
        prepared = _prepare(self.stages, self.plan.node,
                            {n: c // self.p for n, c, _ in sig}, self.p,
                            self.use_megakernel)
        plan, stages = self.plan, self.stages
        use_kernels, slack = self.use_kernels, self.slack
        use_order, overlap = self.use_order, self.overlap_slices
        built = [False]

        def fn(st, mesh):
            account, built[0] = not built[0], True
            return _run(plan, stages, st, mesh, use_kernels, slack,
                        use_order, observe, overlap, account, prepared)

        fn.routes = prepared[1]
        self.cache.put(key, fn)
        return fn

    def run_device(self, staged: Mapping[str, M.MaskedBatch],
                   stats_store=None) -> M.MaskedBatch:
        """Execute on already-bound global batches (on the mesh's first
        device, capacities divisible by the shard count); returns the
        global output batch (device-resident — chain into further mesh
        steps)."""
        staged = {n: staged[n] for n in self._sources if n in staged}
        fn = self._executable(staged, stats_store is not None)
        self._last_routes = fn.routes
        out, counts = fn(staged, self.mesh)
        if stats_store is not None:
            _record(stats_store, self.stages, self._sources, counts)
        return out

    def run(self, bindings: Mapping[str, RecordBatch],
            stats_store=None) -> RecordBatch:
        """Host-bind + execute + fetch: the one-call serving step."""
        out = self.run_device(self.bind(bindings), stats_store=stats_store)
        return out.to_record_batch()

    def cache_stats(self):
        return self.cache.stats()


def compile_distributed(plan, **kwargs) -> DistributedPlan:
    """Build a `DistributedPlan` from a PhysPlan / RankedPlan / OptResult
    (see `DistributedPlan` for the kwargs)."""
    return DistributedPlan(plan, **kwargs)
