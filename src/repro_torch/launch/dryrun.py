"""Multi-pod dry-run: place and build every (arch × shape × mesh) cell on
torch's fake process group, and run it once on meta tensors under the
counters.

Proves the distribution config is coherent without hardware: a layout
DTensor cannot propagate, an op it cannot place or a collective it cannot
issue fails HERE.  The counted run also feeds the roofline analysis
(`launch.roofline`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json

Port of `repro.launch.dryrun`, with its flags, rows and cells.  The
reference forces 512 host devices and runs XLA's `.lower().compile()`;
here each cell makes its own default group on torch's fake backend (256
ranks for the 16x16 pod, 512 for 2x16x16; this process is rank 0),
builds the mesh with `make_production_mesh(device_type="cpu")`, and
destroys the group after the cell.  "Lower" is place and build: the
model on meta, its parameters placed by `parallel.sharding`'s rules,
the optimizer state laid out as them, the batch or decode state placed
as the reference places it.  "Compile" runs the step once under
`roofline.StepCounter`, which counts FLOPs, bytes, collectives and live
memory on this rank's local shards (meta tensors: no data, no memory;
the fake group's collectives move nothing).  `--no-compile` places and
builds and runs nothing.  A process that already has a default group
is refused, and importing the module makes no group and sets nothing in
the environment.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, SHAPES, get_config, input_specs, long_ok
from ..models import make_model
from ..models import transformer as T
from ..models.model import _tree
from ..parallel import sharding as sh
from ..parallel.sharding import NamedSharding
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import TrainConfig, make_train_step
from . import roofline as RL
from .mesh import make_production_mesh


def _batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in sh.mesh_sizes(mesh))


def _batch_sharding(mesh, spec_tree):
    ba = _batch_axes(mesh)
    bsize = _axis_size(mesh, ba)

    def one(path, leaf):
        first = ba if len(ba) > 1 else (ba[0] if ba else None)
        if not leaf.shape or leaf.shape[0] % max(bsize, 1) != 0:
            first = None  # e.g. batch=1 long-context decode: replicate
        extra = (None,) * (len(leaf.shape) - 1)
        return NamedSharding(mesh, sh.placements((first,) + extra, mesh))

    return sh._map(one, spec_tree)


def _axis_size(mesh, axes) -> int:
    size = 1
    d = sh.mesh_sizes(mesh)
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= d.get(a, 1)
    return size


def decode_state_shardings(state_shapes, batch: int, mesh):
    """Sharding rules for decode caches/states (DESIGN.md §6):
    batch dim over (pod, data); KV-cache sequence dim over `model`
    (sequence-parallel decode); everything else replicated.  A leaf that
    is no tensor (a cache's "pos", a Python int) gets None."""
    ba = _batch_axes(mesh)
    bsize = _axis_size(mesh, ba)
    msize = _axis_size(mesh, "model")

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        name = sh._leaf_name(path)
        spec = [None] * len(leaf.shape)
        if name != "pos":
            for i, d in enumerate(leaf.shape):
                if d == batch and batch % max(bsize, 1) == 0 and bsize > 1:
                    spec[i] = ba if len(ba) > 1 else ba[0]
                    break
        if name in ("k", "v") and len(leaf.shape) >= 2:
            sdim = len(leaf.shape) - 2
            if spec[sdim] is None and leaf.shape[sdim] % msize == 0 \
                    and msize > 1:
                spec[sdim] = "model"
        return NamedSharding(mesh, sh.placements(tuple(spec), mesh))

    return sh._map(one, state_shapes)


# Production microbatch counts for the memory-fit run of train cells
# (the reference's, tuned so peak HBM per chip stays under the v5e 16 GiB;
# see EXPERIMENTS.md §Dry-run methodology).
TRAIN_MICROBATCH = {
    "qwen2.5-14b": 8, "llama3.2-1b": 2, "granite-20b": 16, "qwen3-0.6b": 2,
    "rwkv6-3b": 4, "mixtral-8x22b": 64, "qwen2-moe-a2.7b": 8,
    "recurrentgemma-2b": 4, "whisper-tiny": 2, "phi-3-vision-4.2b": 4,
}

# Dry-run lowering knobs (the reference's): layers UNROLLED for the
# roofline compile because XLA cost_analysis counts while-loop bodies
# exactly once (verified in EXPERIMENTS.md §Dry-run); remat=full bounds
# activation memory.  The port always loops over its layers.
ROOFLINE_OVERRIDES = {"scan_layers": False, "remat": "full"}
# fit/production config: scanned layers + blocked (flash-style, O(T·block)
# live memory) attention — the §Perf iteration that removed the materialized
# [T, S] logits matrices from train/prefill peaks
FIT_OVERRIDES = {"scan_layers": True, "remat": "full",
                 "attn_impl": "blocked"}


# ---------------------------------------------------------------------------
# Place and build ("lower"), run once under the counters ("compile")
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Counted:
    """What one counted run of a cell gives: `counts` ({"flops", "hbm",
    "coll"} per device) and the run's memory in bytes."""
    counts: dict
    argument_bytes: int
    output_bytes: int
    temp_bytes: int


@dataclasses.dataclass
class Lowered:
    """A placed and built cell: `fn(*args)` is the step, `args` its
    inputs placed on the mesh."""
    fn: Callable
    args: tuple

    def compile(self) -> Counted:
        """Run the step once under a `roofline.StepCounter`."""
        counter = RL.StepCounter()
        arg_bytes = counter.argument_bytes(self.args)
        with counter:
            out = self.fn(*self.args)
        return Counted(counts=counter.counts(), argument_bytes=arg_bytes,
                       output_bytes=RL.local_bytes(out),
                       temp_bytes=counter.peak)


def _place_tree(tree, shardings):
    """Each tensor of `tree` laid out by the sharding at its place (the
    tensor whole on every rank, each rank keeping its slice)."""
    return sh._map(lambda p, x, s: x if s is None else sh.shard(x, s),
                   tree, shardings)


def _zeros_tree(tree, shardings):
    """Zeros shaped as each tensor of `tree`, laid out by its sharding,
    made on this rank's shard alone (no whole tensor is made)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    def one(path, x, s):
        if s is None:
            return x
        local_shape, _ = compute_local_shape_and_global_offset(
            x.shape, s.mesh, s.placements)
        local = torch.zeros(local_shape, dtype=x.dtype, device=x.device)
        return DTensor.from_local(local, s.mesh, s.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    return sh._map(one, tree, shardings)


def _serving_params(model, mesh):
    """The tree the serving passes read: the parameters placed by the
    rules, cast once to the activation dtype (as `Model.params` casts its
    own), made before the counted run."""
    placed = sh.place_params(model.master_params(), mesh)
    return T.cast_params(_tree(model, placed), model.cfg)


def _lower_train(model, cfg, shape, mesh, microbatches: int):
    params = sh.place_params(model.master_params(), mesh)
    specs = input_specs(cfg, shape)
    opt = init_opt_state(params)
    batch = _place_tree(specs["batch"],
                        _batch_sharding(mesh, specs["batch"]))
    tstep = make_train_step(model, TrainConfig(
        opt=AdamWConfig(), microbatches=microbatches))
    return Lowered(tstep, (params, opt, batch, 0))


def _lower_for_kind(model, cfg, shape, mesh, microbatches: int = 1):
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        return _lower_train(model, cfg, shape, mesh,
                            microbatches=microbatches)
    params = _serving_params(model, mesh)
    if shape.kind == "prefill":
        fresh = model.init_decode_state(shape.batch, shape.seq)
        state_shardings = decode_state_shardings(fresh, shape.batch, mesh)

        @torch.no_grad()
        def serve_prefill(params, batch):
            state = _zeros_tree(fresh, state_shardings)
            with sh.plain_as_replicated(params):
                return T.prefill(params, cfg, batch, state)

        return Lowered(serve_prefill, (params, _place_tree(
            specs["batch"], _batch_sharding(mesh, specs["batch"]))))
    state_shapes = specs["state"]
    state_shardings = decode_state_shardings(state_shapes, shape.batch, mesh)

    @torch.no_grad()
    def serve_step(params, token, state):
        with sh.plain_as_replicated(params):
            return T.decode_step(params, cfg, token, state)

    return Lowered(serve_step, (
        params,
        _place_tree(specs["token"], _batch_sharding(mesh, specs["token"])),
        _place_tree(state_shapes, state_shardings)))


def _measure(counted: Counted) -> dict:
    c = counted.counts
    return {"flops": max(c["flops"], 0.0), "hbm": max(c["hbm"], 0.0),
            "coll": dict(c["coll"])}


def _probe_depths(cfg) -> tuple[int, int] | None:
    """Layer counts for the two-depth roofline probes.  Counted runs of
    40-56 layer stacks under DTensor dispatch are slow on one host, and
    the stacked layers are homogeneous by construction, so per-layer
    costs from (L1, L2) probes extrapolate EXACTLY to the full depth.
    The tail structure (hybrid remainder layers, embeddings, loss) is
    preserved by keeping L ≡ L1 ≡ L2 (mod pattern)."""
    base = max(len(cfg.block_pattern), 1)
    r = cfg.n_layers % base
    l1, l2 = r + 2 * base, r + 4 * base
    if cfg.n_layers <= l2 or cfg.family == "encdec":
        return None
    return l1, l2


def _extrapolate(m1: dict, m2: dict, l1: int, l2: int, full: int) -> dict:
    def ext(a, b):
        per = (b - a) / (l2 - l1)
        return max(a + per * (full - l1), 0.0)

    kinds = set(m1["coll"]) | set(m2["coll"])
    return {"flops": ext(m1["flops"], m2["flops"]),
            "hbm": ext(m1["hbm"], m2["hbm"]),
            "coll": {k: ext(m1["coll"].get(k, 0), m2["coll"].get(k, 0))
                     for k in kinds}}


@contextlib.contextmanager
def fake_group(world: int):
    """A default process group of `world` ranks on torch's fake backend
    (this process is rank 0), destroyed on exit.  A process that already
    has a default group is refused."""
    if dist.is_initialized():
        raise RuntimeError(
            f"the dry-run makes its own default group on torch's fake "
            f"process group; this process already has a "
            f"{str(dist.get_backend())!r} group of {dist.get_world_size()} "
            f"ranks")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               do_compile: bool = True, cfg_overrides: dict | None = None,
               fit_check: bool = True, variant: str = "roofline"):
    """Place and build (and count) one cell; returns a metrics dict.

    variant='roofline' (single-pod): layers unrolled, microbatch=1 — exact
    counts via two-depth probes extrapolated to full depth (see
    `_probe_depths`); train cells ALSO run the production (blocked
    attention + microbatched) full-depth config whose live bytes prove
    per-chip fit.  variant='fit' (multi-pod pass): production config only
    — proves the pod-axis sharding places and runs; the roofline table is
    single-pod."""
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        return _lower_cell(mesh, arch, shape_name, do_compile, cfg_overrides,
                           fit_check, variant)


def _lower_cell(mesh, arch, shape_name, do_compile, cfg_overrides,
                fit_check, variant):
    chips = math.prod(mesh.shape)
    overrides = dict(ROOFLINE_OVERRIDES if variant == "roofline"
                     else FIT_OVERRIDES)
    overrides.update(cfg_overrides or {})
    cfg = get_config(arch, **overrides)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not long_ok(cfg):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
                "skipped": "full attention is O(L^2) at 500k (DESIGN.md §5)"}

    model = make_model(cfg, "meta")
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
           "chips": chips, "params": model.param_count(),
           "variant": variant}
    tokens = shape.batch * shape.seq if shape.kind != "decode" \
        else shape.batch

    t0 = time.perf_counter()
    if variant == "fit":
        lowered = _lower_for_kind(model, cfg, shape, mesh,
                                  TRAIN_MICROBATCH.get(arch, 4))
        row["lower_s"] = round(time.perf_counter() - t0, 2)
        if not do_compile:
            return row
        counted = lowered.compile()
        row["compile_s"] = round(time.perf_counter() - t0, 2)
        row["memory"] = RL.memory_summary(counted)
        row["collectives"] = dict(counted.counts["coll"])
        return row

    # roofline variant
    depths = _probe_depths(cfg)
    if depths is None:
        lowered = _lower_for_kind(model, cfg, shape, mesh)
        row["lower_s"] = round(time.perf_counter() - t0, 2)
        if not do_compile:
            return row
        counted = lowered.compile()
        row["compile_s"] = round(time.perf_counter() - t0, 2)
        m = _measure(counted)
        row["memory"] = RL.memory_summary(counted)
    else:
        if not do_compile:
            _lower_for_kind(model, cfg, shape, mesh)
            row["lower_s"] = round(time.perf_counter() - t0, 2)
            return row
        l1, l2 = depths
        ms = []
        for li in (l1, l2):
            cfg_i = cfg.with_(n_layers=li)
            model_i = make_model(cfg_i, "meta")
            counted_i = _lower_for_kind(model_i, cfg_i, shape,
                                        mesh).compile()
            ms.append(_measure(counted_i))
        row["probe_depths"] = [l1, l2]
        row["compile_s"] = round(time.perf_counter() - t0, 2)
        m = _extrapolate(ms[0], ms[1], l1, l2, cfg.n_layers)

    mf = RL.model_flops_for(cfg, shape.kind, tokens)
    rl = RL.Roofline(flops=m["flops"], hbm_bytes=m["hbm"],
                     coll_bytes=float(sum(m["coll"].values())),
                     coll_by_kind=m["coll"], model_flops=mf, chips=chips)
    row["roofline"] = rl.row()
    row["lower_s"] = row.get("lower_s", round(time.perf_counter() - t0, 2))

    if shape.kind in ("train",) and fit_check:
        fit_cfg = get_config(arch, **dict(FIT_OVERRIDES,
                                          **(cfg_overrides or {})))
        fit_model = make_model(fit_cfg, "meta")
        mb = TRAIN_MICROBATCH.get(arch, 4)
        t0 = time.perf_counter()
        fit_counted = _lower_for_kind(fit_model, fit_cfg, shape, mesh,
                                      microbatches=mb).compile()
        row["fit_compile_s"] = round(time.perf_counter() - t0, 2)
        row["fit_microbatches"] = mb
        row["fit_memory"] = RL.memory_summary(fit_counted)
    elif depths is not None:
        # full-depth production run for the memory-fit column
        fit_cfg = get_config(arch, **dict(FIT_OVERRIDES,
                                          **(cfg_overrides or {})))
        fit_model = make_model(fit_cfg, "meta")
        t0 = time.perf_counter()
        fit_counted = _lower_for_kind(fit_model, fit_cfg, shape,
                                      mesh).compile()
        row["fit_compile_s"] = round(time.perf_counter() - t0, 2)
        row["fit_memory"] = RL.memory_summary(fit_counted)
    return row


def mesh_name(mesh) -> str:
    sizes = sh.mesh_sizes(mesh)
    return "x".join(str(s) for s in sizes.values()) \
        + f"({','.join(sizes)})"


def run_cells(archs, shapes, meshes, do_compile=True, out=None,
              verbose=True):
    rows = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if shape_name == "long_500k" and not long_ok(cfg):
                rows.append({"arch": arch, "shape": shape_name,
                             "mesh": "-", "skipped":
                             "full attention at 500k (DESIGN.md §5)"})
                if verbose:
                    print(f"[skip] {arch} x {shape_name}: full attention")
                if out:
                    with open(out, "w") as f:
                        json.dump(rows, f, indent=1)
                continue
            for multi_pod in meshes:
                try:
                    row = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                     do_compile=do_compile,
                                     variant="fit" if multi_pod
                                     else "roofline")
                except Exception as e:
                    row = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi_pod else "single",
                           "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                rows.append(row)
                if verbose:
                    _print_row(row)
                if out:
                    with open(out, "w") as f:
                        json.dump(rows, f, indent=1)
    return rows


def _print_row(row):
    if "error" in row:
        print(f"[FAIL] {row['arch']} x {row['shape']} x {row['mesh']}: "
              f"{row['error']}")
    elif "skipped" in row:
        print(f"[skip] {row['arch']} x {row['shape']}: {row['skipped']}")
    else:
        rl = row.get("roofline", {})
        mem = row.get("fit_memory", row.get("memory", {}))
        print(f"[ok] {row['arch']:18s} {row['shape']:12s} {row['mesh']:18s} "
              f"lower={row['lower_s']:6.1f}s "
              f"compile={row.get('compile_s', 0):6.1f}s "
              f"fit_peak={mem.get('peak_bytes', 0) / 2**30:6.2f}GiB "
              f"bound={rl.get('bottleneck', '-'):10s} "
              f"useful={rl.get('useful_ratio', 0):.3f} "
              f"rf={rl.get('roofline_fraction', 0):.3f}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" or args.all \
        else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" or args.all \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    rows = run_cells(archs, shapes, meshes, do_compile=not args.no_compile,
                     out=args.out)
    n_ok = sum(1 for r in rows if "error" not in r and "skipped" not in r)
    n_skip = sum(1 for r in rows if "skipped" in r)
    n_fail = sum(1 for r in rows if "error" in r)
    print(f"\n{n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"of {len(rows)} cells")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
