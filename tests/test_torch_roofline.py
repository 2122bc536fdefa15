"""The dry-run's counters (`launch.roofline.StepCounter` under
`launch.dryrun`) on torch's fake process group and on a one-rank mesh.

Every run that makes a process group is a subprocess with a time limit
(`test_torch_sharding.run_procs`), never this process: a default group
left in a pytest worker would change what later tests in it see.  The
counts are held exactly: an all-gather's result bytes computed by hand,
a sharded matmul's per-device FLOPs (not the global ones), the two-depth
probes' extrapolation against the full-depth count, and the count on a
one-rank mesh against `FlopCounterMode` over the plain step on the CPU.
"""

from __future__ import annotations

import json
import sys
import textwrap

import pytest

from test_torch_sharding import FAMILY_ARCHS, SRC, run_procs

PRELUDE = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, %r)
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models import make_model
""") % SRC

FAKE_COUNTS = PRELUDE + textwrap.dedent("""
    out = {}
    with D.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        x = distribute_tensor(torch.empty(1600, 8, device="meta"), mesh,
                              [Replicate(), Shard(0)], src_data_rank=None)
        with RL.StepCounter() as c:
            y = x.redistribute(mesh, [Replicate(), Replicate()])
        out["reshard"] = {"counts": c.counts(),
                          "local": list(y.to_local().shape)}
        a = distribute_tensor(torch.empty(4096, 1024, device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(torch.empty(1024, 2048, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with RL.StepCounter() as c:
            z = a @ b
        out["matmul"] = {"counts": c.counts(),
                         "local": list(z.to_local().shape),
                         "peak": c.peak}
        # the probes against the full depth: REDUCED qwen3-0.6b at 6 layers
        cfg = get_config("qwen3-0.6b", reduced=True,
                         **D.ROOFLINE_OVERRIDES).with_(n_layers=6)
        shape = ShapeSpec("t", "train", 64, 32)
        l1, l2 = D._probe_depths(cfg)
        ms = [D._measure(D._lower_for_kind(
            make_model(cfg.with_(n_layers=n), "meta"), cfg.with_(n_layers=n),
            shape, mesh).compile()) for n in (l1, l2, cfg.n_layers)]
        out["probes"] = {"depths": [l1, l2], "full": ms[2],
                         "extrapolated": D._extrapolate(ms[0], ms[1], l1, l2,
                                                        cfg.n_layers)}
    out["group_after"] = dist.is_initialized()
    print(json.dumps(out))
""")

ONE_RANK = PRELUDE + textwrap.dedent("""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    mesh = make_host_mesh(("data",), "cpu")
    shape = ShapeSpec("t", "train", 16, 2)
    out = {}
    for arch in json.loads(sys.argv[1]):
        cfg = get_config(arch, reduced=True)
        counted = D._lower_for_kind(make_model(cfg, "meta"), cfg, shape,
                                    mesh).compile()
        model = make_model(cfg, "cpu").init(
            torch.Generator().manual_seed(0))
        params = model.master_params()
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16),
                                         dtype=torch.int32)}
        if cfg.family == "vlm":
            batch["img_embeds"] = torch.randn(2, cfg.n_img_tokens,
                                              cfg.d_model)
        if cfg.family == "encdec":
            batch["audio_frames"] = torch.randn(2, cfg.n_audio_frames,
                                                cfg.d_model)
        step = make_train_step(model, TrainConfig())
        with FlopCounterMode(display=False) as fc:
            step(params, init_opt_state(params), batch, 0)
        out[arch] = {"counted": counted.counts["flops"],
                     "plain": fc.get_total_flops(),
                     "memory": RL.memory_summary(counted)}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    out, = run_procs([[sys.executable, "-c", FAKE_COUNTS]],
                     str(tmp_path_factory.mktemp("fake_counts")),
                     timeout=240)
    return json.loads(out)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    out, = run_procs([[sys.executable, "-c", ONE_RANK,
                       json.dumps(FAMILY_ARCHS)]],
                     str(tmp_path_factory.mktemp("one_rank")), timeout=240)
    return json.loads(out)


def test_reshard_counts_the_all_gather_result_bytes(fake):
    """Shard(0) -> Replicate of a [1600, 8] float32 tensor over the
    16-wide `model` axis: one all-gather whose result is the whole
    tensor, 1600 * 8 * 4 bytes; no FLOPs."""
    r = fake["reshard"]
    assert r["counts"]["coll"] == {"all-gather": 1600 * 8 * 4}
    assert r["counts"]["flops"] == 0
    assert r["local"] == [1600, 8]


def test_sharded_matmul_counts_per_device_flops(fake):
    """[4096, 1024] rows split over `data` @ [1024, 2048] columns split
    over `model` on the 16x16 fake mesh: each rank multiplies [256, 1024]
    by [1024, 128], 2 * 256 * 1024 * 128 FLOPs, not the global
    2 * 4096 * 1024 * 2048; its output [256, 128] float32 is the one
    storage made, and no collective runs."""
    m = fake["matmul"]
    assert m["local"] == [256, 128]
    assert m["counts"]["flops"] == 2 * 256 * 1024 * 128
    assert m["counts"]["flops"] != 2 * 4096 * 1024 * 2048
    assert m["counts"]["coll"] == {}
    assert m["peak"] == 256 * 128 * 4


def test_extrapolated_counts_equal_the_full_depth_count(fake):
    """The reduced qwen3-0.6b at 6 layers on the 16x16 fake mesh: the
    (2, 4)-layer probes extrapolate to the 6-layer count exactly, FLOPs,
    bytes and every collective kind (the layers are homogeneous)."""
    p = fake["probes"]
    assert p["depths"] == [2, 4]
    assert p["extrapolated"] == p["full"]
    assert p["full"]["flops"] > 0 and p["full"]["coll"]


def test_the_cell_destroys_its_fake_group(fake):
    assert fake["group_after"] is False


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_one_rank_count_equals_flop_counter_on_the_plain_step(one_rank,
                                                              arch):
    """A reduced train cell (2 x 16 tokens) counted on meta tensors placed
    on a one-rank mesh: the same FLOPs as `FlopCounterMode` over one plain
    step of the same config on the CPU, for each family."""
    r = one_rank[arch]
    assert r["counted"] == r["plain"] > 0
    mem = r["memory"]
    assert mem["peak_bytes"] == mem["temp_bytes"] + mem["argument_bytes"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
