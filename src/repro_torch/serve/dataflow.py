"""Multi-tenant dataflow serving with continuous batching (DESIGN.md §11).

Port of `repro.serve.dataflow`.  Every plan the engine compiles runs on the
engine's `device` ("cuda" by default), so coalesced and solo batches go
through the port's kernels (`span_compact` / `span_segment` on the
megakernel route; `sorted_probe` and `segmented_scan` under
`ServeConfig.use_kernels`).  Two differences from the reference follow
from PyTorch: nothing donates its inputs (there is no buffer donation),
and a regime swap's background build runs its pre-trace on the engine's
own CUDA stream and reports a failure instead of swallowing it
(`join_swaps` raises it).

The compiled-pipeline stack serves ONE flow for ONE caller:
`optimize(...).compile().run_device(bindings)` is fast per batch, but
production traffic is many concurrent tenants submitting small request
batches against many (often semantically identical) flows.  This engine is
the host-side admission layer that turns that traffic into warm device
batches:

* **Routing** — every tenant registers a flow; requests are admitted into a
  queue keyed by the flow's commute-invariant `pipeline.semantic_key`.  Two
  tenants whose flows are equal modulo commutation (and hint regime) land in
  ONE plan group and share its warm executables — the same fingerprint that
  already dedups executables now dedups *serving state*.
* **Coalescing** — queued same-plan requests are merged into one shared
  device batch: each request's source rows are tagged with a dense request
  ordinal (`coalesce_flow` rebuilds the flow so the tag joins every Reduce /
  Match / CoGroup key, keeping tenants' groups and join pairs disjoint by
  construction), concatenated, padded to the geometric
  `masked.bucket_capacity` ladder and executed once on the group's warm
  `CompiledPlan.run_device_observed` path.  Results are
  de-multiplexed back per request by the tag column.  Flows the transform
  cannot carry the tag through (Cross products, non-copying UDFs) fall back
  to solo serving — still on a shared warm executable.
* **Per-tenant statistics** — every tenant owns a private `cost.StatsStore`
  fed ONLY by its own solo-served requests (a deterministic 1-in-
  `probe_every` sample of its traffic runs un-coalesced with observation
  on).  Drift is scored per tenant with the §9 hysteresis band; a tenant
  whose workload durably leaves its hint regime re-calibrates *its own*
  flow and moves to the quantized regime's plan group — a deliberate cache
  miss for the drifter, zero effect on co-tenants, whose group, queue and
  executables stay untouched.  A tenant drifting back re-hits its earlier
  regime's group warm.
* **Truncation repair** — a coalesced batch whose observed rows overran a
  planned capacity is never delivered: its requests are re-served solo
  (whose own overruns force-recalibrate the tenant, §9 semantics), and a
  repeat overrun rebuilds the group's coalesced plan from the
  batch-weighted pool of the members' stores (`cost.pool_stores` — the one
  place pooled statistics are correct, because the shared batch really is
  the mixture).

Typical use::

    eng = DataflowEngine(device="cuda")
    eng.register("tenant-a", flow_a)
    eng.register("tenant-b", flow_b)          # same shape: same plan group
    reqs = [eng.submit("tenant-a", bindings) for bindings in batches]
    eng.drain()                               # or eng.start() for a pump thread
    results = [r.result() for r in reqs]

`launch/serve.py --dataflow` drives the mixed-tenant demo workload;
`chip_smoke.py`'s serving phase measures it on the card (requests/sec,
p50 / p99 latency against the summed solo-flow rate).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..core import flow as F
from ..core.cost import (StatsStore, calibrate_hints, drift_score,
                         pool_stores)
from ..core.enumeration import PlanSpaceExceeded
from ..core.operators import (CoGroupOp, CrossOp, LimitOp, MapOp, MatchOp,
                              Node, ReduceOp, Source)
from ..core.optimizer import optimize
from ..core.pipeline import (CompiledPlan, ExecutableCache, _Interned,
                             compile_plan, semantic_key)
from ..core.record import RecordBatch, Schema, batch_from_dict, resolve_device

# the synthetic per-request ordinal column coalesced batches are keyed on
COALESCE_TAG = "__req"


# ---------------------------------------------------------------------------
# The coalescing transform: one flow, `width` independent requests per batch
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CoalescedFlow:
    """The rebuilt shared-batch flow plus the bookkeeping the engine needs
    to mux and demux requests through it: which tag column each Source
    carries (binary ops force per-side names — a Match's schema union
    rejects a column present on both sides), which tag identifies requests
    in the root's output, and every tag name to strip at demux."""

    root: Node
    source_tags: Mapping[str, str]  # source name -> its tag column
    out_tag: str                    # request ordinal column in the output
    tags: tuple                     # all tag columns (dropped at demux)
    width: int


def coalesce_flow(root: Node, width: int,
                  tag: str = COALESCE_TAG) -> Optional[CoalescedFlow]:
    """Rebuild `root` so one device batch carries up to `width` independent
    requests, kept logically separate by per-request tag columns.

    Every Source gains a leading int64 tag field holding the request
    ordinal (declared sorted — the engine concatenates requests in tag
    order, so each source arrives nondecreasing on `(tag,) + sorted_on`);
    every Reduce/Match/CoGroup key gets its side's tag prepended, so groups
    never merge across requests and join pairs never cross them.  Tag names
    are per-source (`__req0`, `__req1`, ...) because a binary op's schema
    union rejects a column present on both sides; after a join the left
    side's tag becomes the result's canonical request column (the join key
    equated both sides' tags, so surviving tag columns are row-wise
    identical).  PK hints survive: a side unique on `k` per request is
    unique on `(tag, k)` in the shared batch.  `distinct_keys` hints are
    scaled by `width` (each request contributes its own groups); ratio
    hints (selectivity, fanout) are per-record and unchanged.

    Returns None when the flow cannot be coalesced soundly: Cross products
    (pairing is all-to-all, not keyed — tagging would need a Match
    rewrite), combiner halves (physical artifacts, not logical flows), a
    source already using a tag name, or any operator whose UDF does not
    carry its tag through to its output (a non-copying emit would silently
    strip request identity).  Callers fall back to solo serving.
    """
    memo: dict[int, tuple] = {}
    source_tags: dict[str, str] = {}

    def scale(h):
        if h.distinct_keys is None:
            return h
        return dataclasses.replace(h, distinct_keys=int(h.distinct_keys)
                                   * width)

    def rebuild(n: Node) -> tuple:
        hit = memo.get(id(n))
        if hit is not None:
            return hit
        if isinstance(n, Source):
            t = f"{tag}{len(source_tags)}"
            if any(f.startswith(tag) for f in n.out_schema.fields):
                raise _NotCoalescable(f"source {n.name!r} uses a tag name")
            schema = Schema((t,) + n.out_schema.fields,
                            {t: np.dtype(np.int64), **n.out_schema.dtypes})
            out = F.source(n.name, schema, num_records=n.num_records * width,
                           partitioned_on=n.partitioned_on,
                           sorted_on=(t,) + tuple(n.sorted_on or ()))
            source_tags[n.name] = t
        elif isinstance(n, MapOp):
            child, t = rebuild(n.child)
            out = F.map_(child, n.udf, name=n.name, hints=n.hints)
        elif isinstance(n, ReduceOp):
            if n.combiner:
                raise _NotCoalescable(f"{n.name!r} is a combiner half")
            child, t = rebuild(n.child)
            out = F.reduce_(child, (t,) + tuple(n.key), n.udf,
                            name=n.name, hints=scale(n.hints))
        elif isinstance(n, MatchOp):
            left, lt = rebuild(n.left)
            right, rt = rebuild(n.right)
            # anti coalesces soundly: with both tags prepended a left row
            # survives iff no right row shares its (tag, key) — i.e. each
            # request's own anti join, never a cross-request partner
            out = F.match(left, right, (lt,) + tuple(n.left_key),
                          (rt,) + tuple(n.right_key),
                          udf=n.udf, name=n.name, hints=scale(n.hints),
                          anti=n.anti)
            t = lt if lt in out.out_schema else rt
        elif isinstance(n, CoGroupOp):
            left, lt = rebuild(n.left)
            right, rt = rebuild(n.right)
            out = F.cogroup(left, right, (lt,) + tuple(n.left_key),
                            (rt,) + tuple(n.right_key),
                            udf=n.udf, name=n.name, hints=scale(n.hints))
            t = lt if lt in out.out_schema else rt
        elif isinstance(n, LimitOp):
            # a limit is a GLOBAL top-k: prepending the tag to its sort key
            # would rank requests by ordinal, and keeping it un-tagged would
            # let one request's rows crowd out another's — not coalescable
            raise _NotCoalescable(f"{n.name!r} is a Limit")
        elif isinstance(n, CrossOp):
            raise _NotCoalescable(f"{n.name!r} is a Cross")
        else:
            raise _NotCoalescable(type(n).__name__)
        if t not in out.out_schema:
            raise _NotCoalescable(f"{n.name!r} drops the tag")
        memo[id(n)] = (out, t)
        return out, t

    try:
        new_root, out_tag = rebuild(root)
    except (_NotCoalescable, ValueError, TypeError):
        return None
    return CoalescedFlow(root=new_root, source_tags=source_tags,
                         out_tag=out_tag, tags=tuple(source_tags.values()),
                         width=width)


class _NotCoalescable(Exception):
    pass


def coalesce_bindings(requests: Sequence[Mapping[str, RecordBatch]],
                      cf: CoalescedFlow) -> dict[str, RecordBatch]:
    """Concatenate per-request source batches into one tagged binding set
    (request `r`'s rows carry tag value `r`).  Concatenation is in request
    order, so each combined source is sorted on `(tag,) + per-request
    order` — exactly what the coalesced flow's Sources declare."""
    out: dict[str, RecordBatch] = {}
    for name, tag in cf.source_tags.items():
        batches = [req[name].to_numpy().compact() for req in requests]
        sizes = np.array([b.capacity for b in batches])
        cols = {tag: np.repeat(np.arange(len(batches), dtype=np.int64),
                               sizes)}
        for f in batches[0].fields:
            cols[f] = np.concatenate([np.asarray(b.columns[f])
                                      for b in batches])
        out[name] = batch_from_dict(cols)
    return out


def split_result(batch: RecordBatch, n_requests: int,
                 cf: CoalescedFlow) -> list[RecordBatch]:
    """De-multiplex a coalesced output into per-request batches (every tag
    column dropped).  Row order within a request follows the shared batch's
    output order — results are per-request multisets, same as any
    executor's output."""
    b = batch.to_numpy().compact()
    req = np.asarray(b.columns[cf.out_tag])
    rest = [f for f in b.fields if f not in cf.tags]
    return [RecordBatch({f: np.asarray(b.columns[f])[req == r]
                         for f in rest}) for r in range(n_requests)]


# ---------------------------------------------------------------------------
# Cross-tenant common-subplan sharing (DESIGN.md §13)
# ---------------------------------------------------------------------------
SUBPLAN_SHARING_ENV = "REPRO_SUBPLAN_SHARING"


def _subplan_sharing_default() -> bool:
    return os.environ.get(SUBPLAN_SHARING_ENV, "1").lower() \
        not in ("0", "false", "off")


@dataclasses.dataclass(frozen=True)
class SharedPrefix:
    """One flow's shareable upstream: the maximal Source → Map-chain
    `prefix` (every link a single-consumer MapOp — filters and 1:1
    transforms), the `source` it reads, and the `suffix` flow with the
    prefix subtree replaced by a stub Source over the prefix's output
    schema.  At serve time the stub binds — under the ORIGINAL source's
    name — to the fused prefix execution's output batch."""

    prefix: Node
    source: str
    suffix: Node


def shared_prefix(flow: Node) -> Optional[SharedPrefix]:
    """Extract `flow`'s shareable prefix, or None when there is nothing
    worth sharing (no Map directly above a source, a fan-out below the
    first non-Map, or a flow that IS a bare map chain — then there is no
    per-tenant suffix left and solo/coalesced serving already covers it).

    The chain stops at the first operator that is not a single-consumer
    MapOp: Reduces and joins change cardinality per tenant-specific keys,
    and a fan-out means the subtree is not a chain.  Among multiple
    sources the LONGEST chain wins — more fused work per shared batch."""
    parents: dict[int, list] = {}
    seen: set[int] = set()
    for n in flow.iter_nodes():
        if id(n) in seen:
            continue
        seen.add(id(n))
        for c in n.children:
            parents.setdefault(id(c), []).append(n)
    best = None
    for n in flow.iter_nodes():
        if not isinstance(n, Source):
            continue
        cur, chain = n, []
        while True:
            ps = parents.get(id(cur), [])
            if len(ps) != 1 or not isinstance(ps[0], MapOp):
                break
            cur = ps[0]
            chain.append(cur)
        if chain and (best is None or len(chain) > len(best[1])):
            best = (n, chain)
    if best is None:
        return None
    src, chain = best
    prefix = chain[-1]
    if prefix is flow:
        return None
    stub = F.source(src.name, prefix.out_schema,
                    num_records=src.num_records)
    memo: dict[int, Node] = {}

    def rebuild(n: Node) -> Node:
        if n is prefix:
            return stub
        hit = memo.get(id(n))
        if hit is not None:
            return hit
        kids = tuple(rebuild(c) for c in n.children)
        out = n if all(k is c for k, c in zip(kids, n.children)) \
            else n.with_children(*kids)
        memo[id(n)] = out
        return out

    return SharedPrefix(prefix=prefix, source=src.name,
                        suffix=rebuild(flow))


# ---------------------------------------------------------------------------
# Engine configuration and request handle
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the multi-tenant engine (see OPERATIONS.md).

    `max_coalesce` bounds how many queued same-plan requests share one
    device batch (the tag column's range; part of the coalesced flow's
    identity, so changing it recompiles).  `probe_every` sets the
    per-tenant solo-probe cadence: 1 in `probe_every` of a tenant's
    requests is served un-coalesced with observation on, feeding its
    private `StatsStore` — the only input to its drift score, so tenants
    cannot thrash each other.  The drift knobs mirror
    `pipeline.AdaptiveConfig` (§9 hysteresis: arm at `drift_high`, disarm
    at `drift_low`, act after `patience` armed probes); `quant` snaps
    posterior hints onto the 2^(1/quant) grid so a regime is a discrete,
    re-hittable cache identity.  `async_swap` prepares drift-triggered
    regime swaps (optimize + compile + pre-trace) on a background thread so
    the pump never stalls; disable for single-threaded determinism in
    tests.  `use_kernels` routes the probes and aggregates through the
    `sorted_probe` / `segmented_scan` kernels (the megakernel span's
    kernels run either way).  `share_subplans` enables cross-tenant
    common-subplan sharing (tenants in different plan groups whose flows
    open with the same source → map-chain prefix execute it fused once per
    batch); defaults from the `REPRO_SUBPLAN_SHARING` kill switch (`=0`
    disables)."""

    max_coalesce: int = 16
    probe_every: int = 16
    drift_high: float = 1.0
    drift_low: float = 0.5
    patience: int = 2
    min_drift_rows: float = 8.0
    prior_weight: float = 0.0
    quant: int = 4
    optimize_max_plans: int = 4000
    use_kernels: bool = False
    use_order: bool = True
    async_swap: bool = True
    share_subplans: bool = dataclasses.field(
        default_factory=_subplan_sharing_default)


class ServeRequest:
    """One submitted request: bindings in, a `RecordBatch` out.

    `result()` blocks until the engine delivers (pump thread or an explicit
    `pump()`/`drain()` call); `submitted`/`completed` are perf-counter
    stamps for latency accounting."""

    __slots__ = ("tenant", "bindings", "submitted", "completed", "value",
                 "error", "_done")

    def __init__(self, tenant: str, bindings: Mapping[str, RecordBatch]):
        self.tenant = tenant
        self.bindings = bindings
        self.submitted = time.perf_counter()
        self.completed: Optional[float] = None
        self.value: Optional[RecordBatch] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def _deliver(self, value=None, error=None):
        self.value, self.error = value, error
        self.completed = time.perf_counter()
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def latency(self) -> Optional[float]:
        return None if self.completed is None \
            else self.completed - self.submitted

    def result(self, timeout: Optional[float] = None) -> RecordBatch:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request for {self.tenant!r} not served")
        if self.error is not None:
            raise self.error
        return self.value


@dataclasses.dataclass
class _Tenant:
    name: str
    base_flow: Node           # as registered: calibration always restarts here
    flow: Node                # current regime (base flow + posterior hints)
    store: StatsStore         # fed ONLY by this tenant's solo-served requests
    group_key: object = None
    regime_tick: int = 0      # store clock at the last regime change
    armed: int = 0            # consecutive armed drift probes (hysteresis)
    requests: int = 0
    swaps: int = 0
    sample: object = None     # last probe's bindings (pre-traces new regimes)
    pending: object = None    # in-flight background swap (threading.Thread)
    prefix_key: object = None   # share-group key (None: nothing shareable)
    suffix_plan: object = None  # CompiledPlan of the flow minus its prefix


@dataclasses.dataclass
class _PlanGroup:
    """Shared serving state of one calibration regime (one semantic key):
    the queue, the solo plan every member's probes run on, and the
    coalesced plan shared batches run on (None: solo-only fallback)."""

    key: object
    flow: Node                # representative (any member's regime flow)
    solo: CompiledPlan
    coalesced: Optional[CompiledPlan]
    coalesce_info: Optional[CoalescedFlow]
    store: StatsStore         # mixed coalesced-batch obs (truncation repair)
    queue: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    members: set = dataclasses.field(default_factory=set)
    trunc_streak: int = 0
    repairs: int = 0


@dataclasses.dataclass
class _SharedGroup:
    """Serving state of one shared subplan prefix (one commute-invariant
    `semantic_key` of the prefix subtree): the fused prefix's compiled
    plan, the store its boundary observations are attributed to — ONCE per
    fused execution, never once per consuming tenant, so no member's
    private `StatsStore` ever double-counts the shared stage — and the
    member tenants whose flows open with this prefix."""

    key: object
    plan: CompiledPlan
    source: str               # the source the prefix reads (= stub binding)
    store: StatsStore         # fused-prefix obs, attributed exactly once
    members: set = dataclasses.field(default_factory=set)
    batches: int = 0


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
class DataflowEngine:
    """Admission → semantic-key routing → coalescing → demux (DESIGN.md §11).

    Thread-safe on the submission side; device execution is single-threaded
    through `pump()` (call it from your serving loop, or `start()` a
    background pump thread), apart from the pre-trace of a background
    regime swap (`_retarget`), which runs on the engine's own stream.  All
    tenants share one `ExecutableCache`, so regimes revisited by any tenant
    stay warm across the whole engine.  Every plan runs on `device`
    ("cuda" by default; `device="cpu"` runs the kernels' plain versions).
    """

    def __init__(self, config: ServeConfig = ServeConfig(),
                 cache: Optional[ExecutableCache] = None, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else ExecutableCache()
        self._tenants: dict[str, _Tenant] = {}
        self._groups: dict[object, _PlanGroup] = {}
        self._prefixes: dict[object, _SharedGroup] = {}
        self._lock = threading.Lock()
        self._pump_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # background swaps: one at a time on one side stream (the kernels'
        # scratch is keyed by stream, so the pump's and the swap's never
        # meet); their failures are kept for `join_swaps` to raise
        self._swap_mu = threading.Lock()
        self._swap_stream = None
        self._swap_errors: list = []
        # counters (read via .stats())
        self.requests_served = 0
        self.device_batches = 0
        self.coalesced_requests = 0
        self.solo_requests = 0
        self.shared_requests = 0
        self.shared_prefix_batches = 0
        self.truncations = 0

    # -- registration --------------------------------------------------------
    def register(self, tenant: str, flow: Node,
                 seed_stats: bool = True) -> None:
        """Admit a tenant with its flow.  Routing is by `semantic_key`, so a
        flow equal-modulo-commutes to an existing tenant's joins that
        tenant's plan group and shares its warm executables.  With
        `seed_stats`, the new tenant's private store starts from the
        batch-weighted pool of its group co-members' histories (it begins
        life statistically informed); its drift clock starts at the seed, so
        only its OWN subsequent observations can arm a swap."""
        if tenant in self._tenants:
            raise ValueError(f"tenant {tenant!r} already registered")
        g = self._group_for(flow)
        with self._lock:
            store = StatsStore()
            if seed_stats and g.members:
                donors = [self._tenants[m].store for m in g.members]
                store = pool_stores(donors, alpha=store.alpha)
            t = _Tenant(name=tenant, base_flow=flow, flow=flow, store=store,
                        group_key=g.key, regime_tick=store.clock)
            g.members.add(tenant)
            self._tenants[tenant] = t
        self._link_prefix(t)

    def _link_prefix(self, t: _Tenant) -> None:
        """Detect `t`'s shareable (source → map-chain) prefix and join — or
        create — its share group: tenants whose flows open with a
        semantically identical prefix execute it fused (`_pump_shared`).
        The share key is the commute-invariant `semantic_key` of the prefix
        subtree, so it tracks the tenant's hint regime: a recalibrated
        tenant re-links under its NEW prefix key, leaving its old share
        group instead of dragging co-sharers onto its regime.  The
        expensive builds (prefix plan once per share group, suffix plan per
        tenant) run unlocked; insertion is first-wins."""
        cfg = self.config
        if not cfg.share_subplans:
            return
        sp = shared_prefix(t.flow)
        if sp is None:
            return
        key = _Interned(semantic_key(sp.prefix))
        with self._lock:
            sg = self._prefixes.get(key)
        if sg is None:
            plan = self._compile(self._plan_for(sp.prefix))
            sg = _SharedGroup(key=key, plan=plan, source=sp.source,
                              store=StatsStore())
            with self._lock:
                sg = self._prefixes.setdefault(key, sg)
        suffix = self._compile(self._plan_for(sp.suffix))
        with self._lock:
            sg.members.add(t.name)
            t.prefix_key, t.suffix_plan = key, suffix

    def _unlink_prefix(self, t: _Tenant) -> None:
        with self._lock:
            sg = self._prefixes.get(t.prefix_key)
            if sg is not None:
                sg.members.discard(t.name)
            t.prefix_key = t.suffix_plan = None

    def _compile(self, plan) -> CompiledPlan:
        """Every plan of the engine: its cache, kernels, order use and
        device."""
        cfg = self.config
        return compile_plan(plan, cache=self.cache,
                            use_kernels=cfg.use_kernels,
                            use_order=cfg.use_order, device=self.device)

    def _plan_for(self, flow: Node):
        """Best physical plan (shipping + order Props thread into the
        lowering); an exploding plan space falls back to the logical flow
        (compile_plan lowers it directly)."""
        try:
            return optimize(flow, max_plans=self.config.optimize_max_plans,
                            include_commutes=False).best.plan
        except PlanSpaceExceeded:
            return flow

    def _group_for(self, flow: Node) -> _PlanGroup:
        """The plan group serving `flow`'s semantic regime, built on first
        use: one optimized solo plan (probes + fallback) and one optimized
        coalesced plan (shared batches), both cached engine-wide.  Safe to
        call from the pump thread or a background swap thread: the
        expensive build runs unlocked, insertion is first-wins."""
        cfg = self.config
        key = _Interned(semantic_key(flow))
        with self._lock:
            g = self._groups.get(key)
        if g is not None:
            return g
        solo = self._compile(self._plan_for(flow))
        coalesced, cf = None, None
        if cfg.max_coalesce > 1:
            cf = coalesce_flow(flow, cfg.max_coalesce)
            if cf is not None:
                coalesced = self._compile(self._plan_for(cf.root))
        g = _PlanGroup(key=key, flow=flow, solo=solo, coalesced=coalesced,
                       coalesce_info=cf, store=StatsStore())
        with self._lock:
            return self._groups.setdefault(key, g)

    # -- admission -----------------------------------------------------------
    def submit(self, tenant: str,
               bindings: Mapping[str, RecordBatch]) -> ServeRequest:
        """Enqueue one request into its tenant's current plan-group queue."""
        t = self._tenants[tenant]
        req = ServeRequest(tenant, bindings)
        with self._lock:
            self._groups[t.group_key].queue.append(req)
        return req

    def pending(self) -> int:
        with self._lock:
            return sum(len(g.queue) for g in self._groups.values())

    # -- serving loop --------------------------------------------------------
    def pump(self, max_batches: Optional[int] = None) -> int:
        """Drain queues: per plan group, pop up to `max_coalesce` requests,
        divert probe-due ones to observed solo serving, run the rest as one
        coalesced device batch, demux and deliver.  Returns the number of
        requests completed.  Groups are swept round-robin so no tenant
        starves behind a deep co-queue."""
        served = batches = 0
        with self._pump_lock:
            served += self._pump_shared()
            while max_batches is None or batches < max_batches:
                progressed = False
                for g in list(self._groups.values()):
                    if not g.queue:
                        continue
                    with self._lock:
                        reqs = [g.queue.popleft()
                                for _ in range(min(len(g.queue),
                                                   self.config.max_coalesce))]
                    served += self._serve_batch(g, reqs)
                    batches += 1
                    progressed = True
                    if max_batches is not None and batches >= max_batches:
                        break
                if not progressed:
                    break
        return served

    def drain(self) -> int:
        """Pump until every queue is empty (including requeues from
        mid-drain regime moves)."""
        total = 0
        while self.pending():
            total += self.pump()
        return total

    def start(self, poll_s: float = 0.0005) -> None:
        """Run the pump on a daemon thread until `stop()` (the async serve
        loop: submissions from any thread, device work on this one)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if self.pump() == 0:
                    time.sleep(poll_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="dataflow-pump")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    # -- the shared-subplan path ---------------------------------------------
    def _pump_shared(self) -> int:
        """Cross-group sweep ahead of the per-group one: queued requests
        whose tenants share a prefix group spanning ≥2 plan groups AND bind
        the IDENTICAL source batch (same `RecordBatch` object — the
        pairing fingerprint) are extracted and served through one fused
        prefix execution feeding each tenant's own suffix plan.  Everything
        else stays queued for the normal solo/coalesced sweep."""
        if not self.config.share_subplans:
            return 0
        buckets: dict[tuple, list] = {}
        with self._lock:
            eligible = {}
            for key, sg in self._prefixes.items():
                if len(sg.members) < 2:
                    continue
                regimes = {self._tenants[m].group_key for m in sg.members}
                if len(regimes) >= 2:
                    eligible[key] = sg
            if not eligible:
                return 0
            for g in self._groups.values():
                for req in g.queue:
                    t = self._tenants.get(req.tenant)
                    sg = eligible.get(t.prefix_key) if t else None
                    if sg is None:
                        continue
                    src = req.bindings.get(sg.source)
                    if src is None:
                        continue
                    buckets.setdefault((t.prefix_key, id(src)),
                                       []).append(req)
            take: set[int] = set()
            for fp, rs in list(buckets.items()):
                gks = {self._tenants[r.tenant].group_key for r in rs}
                # a fused prefix pays off only across plan groups — same-
                # group requests coalesce better on the normal path
                if len({r.tenant for r in rs}) < 2 or len(gks) < 2:
                    del buckets[fp]
                    continue
                take.update(id(r) for r in rs)
            if not take:
                return 0
            for g in self._groups.values():
                if g.queue:
                    g.queue = collections.deque(
                        r for r in g.queue if id(r) not in take)
        served = 0
        for (key, _), rs in buckets.items():
            served += self._serve_shared(self._prefixes[key], rs)
        return served

    def _serve_shared(self, sg: _SharedGroup, reqs: list) -> int:
        """One fused prefix execution for `reqs` (all bound to the same
        source batch), observed ONCE into the share group's store; each
        request then runs its tenant's suffix plan on the prefix output,
        observed into that tenant's private store — so per-tenant stats
        stay disjoint from the shared stage and from each other.  Any
        truncation (prefix or suffix) falls back to the solo path, whose
        own repair policy applies."""
        cfg = self.config
        probes, share = [], []
        for req in reqs:
            t = self._tenants[req.tenant]
            t.requests += 1
            due = (t.requests == 1
                   or t.requests % cfg.probe_every == 0)
            (probes if due else share).append(req)
        for req in probes:
            self._serve_solo(req)
        if len({r.tenant for r in share}) < 2:
            for req in share:   # pairing evaporated into probes
                self._serve_solo(req)
            return len(reqs)
        try:
            plan = sg.plan
            staged = plan.bind_device(
                {sg.source: share[0].bindings[sg.source]})
            out, counts, caps = plan.run_device_observed(staged)
            trunc = plan.fold_observation(sg.store, counts, caps=caps)
        except Exception:
            for req in share:
                self._serve_solo(req)
            return len(reqs)
        if trunc is not None:   # prefix overran: its output is missing rows
            self.truncations += 1
            for req in share:
                self._serve_solo(req)
            return len(reqs)
        pre = out.to_record_batch()
        sg.batches += 1
        self.shared_prefix_batches += 1
        self.device_batches += 1
        for req in share:
            t = self._tenants[req.tenant]
            try:
                bindings = dict(req.bindings)
                bindings[sg.source] = pre
                cp = t.suffix_plan
                staged = cp.bind_device(bindings)
                o, c, caps2 = cp.run_device_observed(staged)
                if cp.fold_observation(t.store, c, caps=caps2) is not None:
                    self.truncations += 1
                    self._serve_solo(req)   # solo path force-recalibrates
                    continue
                self._drift_check(t)
                req._deliver(value=o.to_record_batch())
                self.shared_requests += 1
                self.requests_served += 1
                self.device_batches += 1
            except Exception as e:
                req._deliver(error=e)
        return len(reqs)

    # -- the two serve paths -------------------------------------------------
    def _serve_batch(self, g: _PlanGroup, reqs: list) -> int:
        cfg = self.config
        probes, shared = [], []
        for req in reqs:
            t = self._tenants[req.tenant]
            t.requests += 1
            # the tenant's very first request always probes (seeds its
            # store), then a deterministic 1-in-probe_every sample does
            due = (t.requests == 1
                   or t.requests % cfg.probe_every == 0)
            (probes if due else shared).append(req)
        if len(shared) < 2 or g.coalesced is None:
            probes, shared = probes + shared, []
        for req in probes:
            self._serve_solo(req)
        if shared:
            self._serve_coalesced(g, shared)
        return len(reqs)

    def _serve_solo(self, req: ServeRequest) -> None:
        """Observed solo serve: the request runs alone on its tenant's
        CURRENT group's warm solo executable, its boundary counts feed the
        tenant's private store, and the §9 drift/truncation policy runs for
        this tenant only.  A capacity overrun force-recalibrates and
        re-runs (bounded by the plan's stage count, as in `CompiledPlan`)."""
        t = self._tenants[req.tenant]
        attempts = 0
        try:
            while True:
                g = self._groups[t.group_key]
                staged = g.solo.bind_device(req.bindings)
                out, counts, caps = g.solo.run_device_observed(staged)
                trunc = g.solo.fold_observation(t.store, counts, caps=caps)
                if trunc is None:
                    t.sample = req.bindings
                    break
                self.truncations += 1
                self._retarget(t, force=True)
                attempts += 1
                if attempts > len(g.solo.stages) + 2:
                    raise RuntimeError(
                        f"tenant {t.name!r}: capacity overrun persists "
                        f"after {attempts} recalibrations")
            self._drift_check(t)
            self.solo_requests += 1
            self.requests_served += 1
            self.device_batches += 1
            req._deliver(value=out.to_record_batch())
        except Exception as e:  # deliver, don't wedge the pump
            req._deliver(error=e)

    def _serve_coalesced(self, g: _PlanGroup, reqs: list) -> None:
        """One shared device batch for `reqs` (all same plan group): tag,
        concatenate, execute on the warm coalesced executable, demux by
        tag.  An observed capacity overrun discards the batch (it is
        missing rows) and re-serves every request solo; a repeat overrun
        rebuilds the coalesced plan from the members' pooled stores."""
        cp = g.coalesced
        try:
            combined = coalesce_bindings([r.bindings for r in reqs],
                                         g.coalesce_info)
            staged = cp.bind_device(combined)
            out, counts, caps = cp.run_device_observed(staged)
            trunc = cp.fold_observation(g.store, counts, caps=caps)
        except Exception as e:
            for r in reqs:
                r._deliver(error=e)
            return
        if trunc is not None:
            self.truncations += 1
            g.trunc_streak += 1
            if g.trunc_streak >= 2:
                self._repair_group(g)
            for r in reqs:  # correct results via the solo path's own repair
                self._serve_solo(r)
            return
        g.trunc_streak = 0
        parts = split_result(out.to_record_batch(), len(reqs),
                             g.coalesce_info)
        now = time.perf_counter()
        for r, part in zip(reqs, parts):
            r.value, r.error, r.completed = part, None, now
            r._done.set()
        self.coalesced_requests += len(reqs)
        self.requests_served += len(reqs)
        self.device_batches += 1

    # -- feedback policy (per tenant; DESIGN.md §11) -------------------------
    def _drift_check(self, t: _Tenant) -> None:
        cfg = self.config
        if t.pending is not None:    # a swap is already being prepared
            return
        score = drift_score(t.flow, t.store, min_rows=cfg.min_drift_rows,
                            newer_than=t.regime_tick)
        if score >= cfg.drift_high:
            t.armed += 1
        elif score <= cfg.drift_low:
            t.armed = 0
        if t.armed >= cfg.patience:
            self._retarget(t)

    def _retarget(self, t: _Tenant, force: bool = False) -> bool:
        """Recalibrate `t`'s flow from its own store and, if the quantized
        posterior lands in a new regime, move the tenant to that regime's
        plan group (created on first use, re-hit warm on a drift back).
        Only `t` moves: co-tenants keep their queue, plans and cache
        entries untouched.

        Hysteresis-triggered swaps are prepared on a background thread
        (`async_swap`): the new group is built, its executables pre-traced
        on the tenant's last probe bindings, and only then is the tenant
        moved — the pump keeps serving every tenant (including this one, on
        its stale-but-correct old regime) in the meantime.  A failed build
        or pre-trace leaves the tenant where it is and is raised by
        `join_swaps`.
        Truncation-forced swaps (`force`) stay synchronous: the result that
        exposed the overrun is wrong and must be recomputed NOW on the
        repaired plan."""
        cfg = self.config
        calibrated = calibrate_hints(
            t.base_flow, t.store,
            prior_weight=0.0 if force else cfg.prior_weight, quant=cfg.quant)
        key = _Interned(semantic_key(calibrated))
        if key == t.group_key:
            t.armed = 0
            return False
        if force or not cfg.async_swap:
            self._move(t, calibrated, self._group_for(calibrated))
            return True
        sample = t.sample

        def build():
            try:
                with self._swap_mu, self._swap_device():
                    g = self._group_for(calibrated)
                    if sample is not None:
                        self._pretrace(g, sample)
                self._move(t, calibrated, g)
            except Exception as e:  # kept for join_swaps to raise
                self._swap_errors.append(e)
            finally:
                t.pending = None

        t.armed = 0
        t.pending = threading.Thread(target=build, daemon=True,
                                     name=f"swap-{t.name}")
        t.pending.start()
        return True

    def _move(self, t: _Tenant, calibrated: Node, g: _PlanGroup) -> None:
        with self._lock:
            self._groups[t.group_key].members.discard(t.name)
            t.flow = calibrated
            g.members.add(t.name)
            # requests already queued under the old regime still serve there
            # (correctness does not depend on hints); new submissions route
            # to the new group's queue
            t.group_key = g.key
        t.swaps += 1
        t.regime_tick = t.store.clock
        t.armed = 0
        # the drifter re-links under its NEW regime's prefix key — it leaves
        # its old share group; co-sharers keep their fused prefix untouched
        self._unlink_prefix(t)
        self._link_prefix(t)

    def _swap_device(self):
        """Where a swap thread's device work runs: on a CUDA device, the
        engine's card (a new thread's current device is card 0) and the
        engine's own stream, made once — the look-back kernels keep their
        scratch per stream, so a pre-trace never shares the pump's."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._swap_stream is None:
            self._swap_stream = torch.cuda.Stream(device=self.device)
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._swap_stream))
        return stack

    def _pretrace(self, g: _PlanGroup, sample) -> None:
        """Warm a freshly built group's executables off the serving path by
        running them once on copies of a probe's bindings (the coalesced
        plan sees a full-width batch, so the serving-time capacity bucket is
        the one that builds).  The run is waited for, so a kernel failure
        raises here, on the swap thread, and the tenant does not move."""
        g.solo.run_device_observed(g.solo.bind_device(sample))
        if g.coalesced is not None:
            w = g.coalesce_info.width
            combined = coalesce_bindings([sample] * w, g.coalesce_info)
            g.coalesced.run_device_observed(g.coalesced.bind_device(combined))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def join_swaps(self, timeout: Optional[float] = None) -> None:
        """Block until every in-flight background regime swap has been
        published (tests and benchmarks; serving code never needs this);
        raises the first failure of a swap's build or pre-trace."""
        for t in list(self._tenants.values()):
            th = t.pending
            if th is not None:
                th.join(timeout)
        if self._swap_errors:
            raise RuntimeError("a background regime swap failed") \
                from self._swap_errors[0]

    def _repair_group(self, g: _PlanGroup) -> None:
        """Rebuild a group's coalesced plan after repeated shared-batch
        overruns, calibrating from the batch-weighted POOL of the members'
        stores (`cost.pool_stores`) — the shared batch is the members'
        mixture, so the pool is the one statistic that prices it.  The
        group's identity (and the members' solo regimes) are unchanged;
        the new coalesced executable is a deliberate cache miss."""
        members = [self._tenants[m].store for m in sorted(g.members)]
        if not members:
            return
        pooled = pool_stores(members)
        calibrated = calibrate_hints(g.flow, pooled, prior_weight=0.0,
                                     quant=self.config.quant)
        cf = coalesce_flow(calibrated, self.config.max_coalesce)
        if cf is None:
            g.coalesced = g.coalesce_info = None
            return
        g.coalesce_info = cf
        g.coalesced = self._compile(self._plan_for(cf.root))
        g.trunc_streak = 0
        g.repairs += 1

    # -- introspection -------------------------------------------------------
    def tenant_stats(self, tenant: str) -> dict:
        t = self._tenants[tenant]
        sg = self._prefixes.get(t.prefix_key)
        return {"requests": t.requests, "swaps": t.swaps,
                "armed": t.armed, "regime_tick": t.regime_tick,
                "group_size": len(self._groups[t.group_key].members),
                "share_group_size": len(sg.members) if sg else 0,
                "store_batches": t.store.clock}

    def stats(self) -> dict:
        return {"requests_served": self.requests_served,
                "device_batches": self.device_batches,
                "coalesced_requests": self.coalesced_requests,
                "solo_requests": self.solo_requests,
                "shared_requests": self.shared_requests,
                "shared_prefix_batches": self.shared_prefix_batches,
                "truncations": self.truncations,
                "groups": len(self._groups),
                "share_groups": len(self._prefixes),
                "repairs": sum(g.repairs for g in self._groups.values()),
                "swap_errors": len(self._swap_errors),
                "pending": self.pending(),
                "cache": self.cache.stats()}
