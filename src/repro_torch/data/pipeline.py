"""Training input pipeline BUILT ON the optimized data-flow plane.

Port of `repro.data.pipeline`.  This is the paper's system in its
production role: the host-side record pipeline that feeds the training
loop.  A PACT flow (black-box UDFs over a synthetic document store) is
optimized by `core.optimizer` — filter pushdown, dedup-before-join, etc. —
then executed per step by the eager host executor (numpy, as the
reference's) to produce the records whose token payloads fill the train
batch.  The token rows are made on the host, then copied to the device.

Determinism: batches are a pure function of (seed, step) — the Supervisor's
restart path replays the stream exactly (no loss/duplication on failover).
The batch takes the first `batch` rows of the executor's result, so the
port's tokens equal the reference's only because both optimizers pick the
same plan and both executors return its rows in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import executor, flow as F
from ..core.operators import Hints
from ..core.optimizer import OptResult, optimize
from ..core.physical import Ctx
from ..core.record import Schema, as_numpy, batch_from_dict, resolve_device


def corpus_flow(min_len: int = 64, num_docs: int = 1_000_000):
    """Document-cleaning flow: quality filter -> dedup (Reduce on content
    hash) -> join with per-domain language priors -> weighted sample score."""
    docs = F.source("docs", Schema.of(
        doc_id=np.int64, domain=np.int64, content_h=np.int64,
        length=np.int64, quality=np.float64, tok_seed=np.int64),
        num_records=num_docs)
    domains = F.source("domains", Schema.of(
        dom_id=np.int64, dom_weight=np.float64), num_records=1024)

    def quality_filter(ir, out):
        out.emit(ir.copy(), where=(ir.get("quality") > 0.25)
                 & (ir.get("length") >= min_len))

    def dedup(g, out):  # keep one doc per (content hash, domain)
        out.emit(g.keys().set("doc_id", g.min("doc_id"))
                 .set("length", g.max("length"))
                 .set("tok_seed", g.min("tok_seed")))

    def weight(ir, out):
        out.emit(ir.copy().set("w", ir.get("dom_weight") * 1000.0))

    q = F.map_(docs, quality_filter, name="QualityFilter",
               hints=Hints(selectivity=0.6))
    # domain joins the dedup key, so the PK join on domain can be reordered
    # past the Reduce (invariant grouping) — the pipeline's main rewrite
    d = F.reduce_(q, ["content_h", "domain"], dedup, name="Dedup",
                  hints=Hints(distinct_keys=int(num_docs * 0.5)))
    j = F.match(d, domains, ["domain"], ["dom_id"], name="DomainJoin",
                hints=Hints(pk_side="right"))
    root = F.map_(j, weight, name="DomainWeight")

    def bindings(n: int, seed: int):
        rng = np.random.default_rng(seed)
        return {
            "docs": batch_from_dict({
                "doc_id": np.arange(n, dtype=np.int64),
                "domain": rng.integers(0, 1024, n),
                "content_h": rng.integers(0, max(n // 2, 1), n),
                "length": rng.integers(16, 4096, n),
                "quality": rng.random(n).round(3),
                "tok_seed": rng.integers(0, 2**40, n)}),
            "domains": batch_from_dict({
                "dom_id": np.arange(1024, dtype=np.int64),
                "dom_weight": rng.uniform(0.1, 2.0, 1024).round(3)}),
        }

    return root, bindings


@dataclasses.dataclass
class TokenPipeline:
    """Deterministic (seed, step) -> train batch, through the optimized
    flow: `{"tokens": int32 [batch, seq] on device}`."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0
    docs_per_step: int = 4096
    optimized: Optional[OptResult] = None
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.flow, self.bindings = corpus_flow()
        if self.optimized is None:
            self.optimized = optimize(self.flow, Ctx(dop=32),
                                      include_commutes=False)
        self.best_flow = self.optimized.best.flow

    def host_tokens(self, step: int) -> np.ndarray:
        """The batch's token rows on the host, int32 [batch, seq]."""
        b = self.bindings(self.docs_per_step, self.seed * 1_000_003 + step)
        recs = executor.execute(self.best_flow, b)
        # token payload: deterministic synthetic stream seeded per record
        seeds = as_numpy(recs["tok_seed"])[:self.batch]
        if len(seeds) < self.batch:  # pad by cycling
            reps = int(np.ceil(self.batch / max(len(seeds), 1)))
            seeds = np.tile(seeds, reps)[:self.batch]
        toks = np.empty((self.batch, self.seq), np.int32)
        for i, s in enumerate(seeds):
            rng = np.random.default_rng(int(s) ^ (step << 20) ^ i)
            toks[i] = rng.integers(0, self.vocab, self.seq)
        return toks

    def __call__(self, step: int) -> dict:
        return {"tokens": torch.from_numpy(self.host_tokens(step))
                .to(self.device)}
