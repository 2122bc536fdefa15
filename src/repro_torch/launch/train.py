"""Training launcher: any --arch on the local mesh (the production
shardings where the mesh's axes allow), fed by the optimized data-flow
pipeline, supervised with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --steps 100 --batch 8 --seq 128 [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train ...

Port of `repro.launch.train`, with its flags and `--device`: it runs on the
card unless told otherwise.  As the reference's, it places the parameters
by `parallel.sharding.validated_pspecs` on `launch.mesh.make_host_mesh(
("data",))` — every rank of the process group on one axis: one rank on
an in-process store when started alone, the group `torchrun` describes
otherwise (NCCL on the card, gloo with `--device cpu`) — and each batch
by `batch_pspec`, and runs the `Supervisor` over the placed state.  It
has no donation: the step returns new tensors and the old ones are freed
when dropped.  Every rank draws the whole model from a generator seeded
with 0 and keeps its slices, as the reference's launcher draws from
`jax.random.key(0)` (other numbers, the same distributions).  The
config is the registry's, so attention is plain (`attn_impl="xla"`) and
the recurrences take their plain paths: no CUDA kernel has a backward.
The checkpoint directory defaults to `repro_train_ckpt` under the
temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from types import SimpleNamespace

import torch

from ..configs import ARCH_IDS, get_config
from ..core.record import resolve_device
from ..data.pipeline import TokenPipeline
from ..models import make_model
from ..parallel.sharding import mesh_sizes, place_batch, place_params
from ..train.fault import Supervisor
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import TrainConfig, make_train_step
from .mesh import make_host_mesh


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace) -> SimpleNamespace:
    """Everything the run needs, placed on the host mesh: `model` (whole
    on every rank), `mesh`, `state` (the placed parameters and AdamW
    state at step 0), `pipe`, `tcfg`, `step_fn`, `batch_fn` (the
    pipeline's batch for a step, placed) and `sup`."""
    cfg = get_config(args.arch, reduced=args.reduced)
    mesh = make_host_mesh(("data",), torch.device(args.device).type)
    device = resolve_device(args.device)
    model = make_model(cfg, device).init(
        torch.Generator(device=device).manual_seed(0))
    print(f"[train] {cfg.name} on {device}, mesh {mesh_sizes(mesh)}: "
          f"{model.param_count() / 1e6:.1f}M params")
    params = place_params(model.master_params(), mesh)
    opt = init_opt_state(params)

    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         device=device)
    print("[train] pipeline plan:", pipe.optimized.best.order())

    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                        total_steps=args.steps),
        microbatches=args.microbatches,
        compress_grads=args.compress_grads)
    return SimpleNamespace(
        model=model, mesh=mesh, pipe=pipe, tcfg=tcfg,
        state={"params": params, "opt": opt, "step": 0},
        step_fn=make_train_step(model, tcfg),
        batch_fn=lambda step: place_batch(pipe(step), mesh),
        sup=Supervisor(ckpt_dir=args.ckpt_dir,
                       ckpt_every=max(args.steps // 4, 10)))


def main(argv=None):
    args = parse_args(argv)
    run = setup(args)
    state, wd = run.sup.run(state=run.state, train_step=run.step_fn,
                            batch_fn=run.batch_fn, num_steps=args.steps,
                            log_every=10)
    print(f"[train] finished at step {state['step']}, "
          f"stragglers={len(wd.events)}")
    return state


if __name__ == "__main__":
    main()
