"""Serving launcher: batched token generation for an --arch of any family
(dense, moe, rwkv6, hybrid, vlm, encdec), or the multi-tenant data-flow
engine (DESIGN.md §11).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --requests 8 --max-new 16 [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve --dataflow \
        --requests 64 --rows 512 [--device cpu]

Port of `repro.launch.serve`, with its flags and `--device`: it runs on the
card unless told otherwise.  `--dataflow` serves a mixed workload (q15,
clickstream and textmining tenants, plus a drifting q15-shaped tenant)
through `serve.dataflow.DataflowEngine` on a background pump thread and
reports per-tenant throughput, swaps and the engine's cache behaviour.  The config is the
registry's, as in the reference, so attention is plain (`attn_impl="xla"`)
and the CUDA flash kernel runs only for a config that asks for
`attn_impl="flash"`; the model leaves `use_kernel` unset, as the
reference's launcher does, so the rwkv6 and RG-LRU recurrences take their
plain paths.  Weights are drawn from a seeded generator, as the
reference's launcher does; no checkpoint is read.  The Engine sends each
request's tokens only, as the reference's does: a vlm request is served
as text alone (no `img_embeds`), and an encdec (whisper) prefill stops
with a `ValueError` naming the missing `audio_frames`, where the
reference's stops with a `KeyError`.  Whisper and the vlm's image prefix
are reached through `Model.prefill` / `decode_step` with those inputs in
the batch.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..models import make_model
from ..serve.engine import Engine, Request


def _main_dataflow(args):
    from ..configs import flows
    from ..serve.dataflow import DataflowEngine, ServeConfig

    q15_root, q15_b = flows.q15()
    ck_root, ck_b = flows.clickstream()
    tm_root, tm_b = flows.textmining()
    dr_root, dr_b = flows.q15_drift(hint_selectivity=1.0)
    tenants = [
        ("q15", q15_root, lambda n, s: q15_b(n, seed=s)),
        ("click", ck_root, lambda n, s: ck_b(n, seed=s)),
        ("text", tm_root, lambda n, s: tm_b(n, seed=s)),
        ("drift", dr_root, lambda n, s: dr_b(n, seed=s, true_sel=0.04)),
    ]
    eng = DataflowEngine(ServeConfig(max_coalesce=16, probe_every=8),
                         device=args.device)
    for name, root, _ in tenants:
        eng.register(name, root)

    eng.start()  # pump on a background thread; submissions from this one
    try:
        t0 = time.perf_counter()
        reqs = [eng.submit(name, mk(args.rows, 1000 * ti + i))
                for i in range(args.requests)
                for ti, (name, _, mk) in enumerate(tenants)]
        for r in reqs:
            r.result(timeout=300)
        dt = time.perf_counter() - t0
        eng.join_swaps(timeout=60)
    finally:
        eng.stop()

    lat = np.array([r.latency for r in reqs])
    print(f"[dataflow] {len(reqs)} requests x {args.rows} rows over "
          f"{len(tenants)} tenants on {eng.device} in {dt:.2f}s "
          f"({len(reqs) / dt:.0f} req/s, "
          f"p99 {np.percentile(lat, 99) * 1e3:.1f}ms)")
    for name, _, _ in tenants:
        print(f"  {name}: {eng.tenant_stats(name)}")
    print(f"  engine: {eng.stats()}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataflow", action="store_true",
                    help="serve the mixed dataflow-tenant demo workload "
                         "instead of token generation")
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--rows", type=int, default=512,
                    help="rows per dataflow request (--dataflow only)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dataflow:
        return _main_dataflow(args)

    cfg = get_config(args.arch, reduced=args.reduced)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = make_model(cfg, device).init(gen)
    engine = Engine(model, batch_slots=args.slots, max_seq=args.max_seq)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, rng.integers(3, 16))
                    .astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    engine.generate(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in reqs)
    attn = "" if cfg.family == "rwkv6" else f", {cfg.attn_impl} attention"
    print(f"[serve] {cfg.name} on {device} ({cfg.family}{attn}): "
          f"{len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s)")
    for i, r in enumerate(reqs[:4]):
        print(f"  req{i}: {r.out_tokens}")


if __name__ == "__main__":
    main()
