"""The port on the card: each CUDA kernel against its plain torch version,
and the main path with the kernels against the eager executor.

Marked `cuda`; every test skips without a CUDA device (the kernels have no
CPU mode).  Imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.configs import flows
from repro_torch.core import executor
from repro_torch.core.optimizer import optimize
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

OPS = ("add", "max", "min")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_cuda_sorted_probe_matches_plain(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    for n, m in [(0, 7), (1, 1), (10_000, 100_003), (1_000_000, 65_536)]:
        keys = torch.sort(torch.randint(-10**6, 10**6, (n,), generator=g)
                          .to(dtype)).values.to(cuda)
        q = torch.randint(-10**6, 10**6, (m,), generator=g).to(dtype).to(cuda)
        got = tops.sorted_probe(keys, q)
        assert torch.equal(got, tref.sorted_probe(keys, q))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_cuda_segmented_scan_matches_plain(cuda, dtype, c):
    g = torch.Generator().manual_seed(1)
    for n, op in [(1, "add"), (2049, "max"), (300_007, "min"),
                  (300_007, "add")]:
        v = torch.randint(-1000, 1000, (n, c), generator=g).to(dtype).to(cuda)
        f = (torch.rand(n, generator=g) < 0.01).to(cuda)
        # small integers: float sums are exact in any order
        assert torch.equal(tops.segmented_scan(v, f, op),
                           tref.segmented_scan(v, f, op))
        sid = torch.cumsum(f.to(torch.int64), 0)
        valid = (torch.rand(n, generator=g) < 0.9).to(cuda)
        nseg = int(sid[-1]) + 3
        assert torch.equal(tops.segment_reduce(v, sid, nseg, op, valid),
                           tref.segment_reduce(v, sid, nseg, op, valid))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    flags = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="at most 4 columns"):
        tops.segmented_scan(torch.zeros((8, 5), dtype=torch.int64,
                                        device=cuda), flags)
    with pytest.raises(TypeError):
        tops.segmented_scan(torch.zeros(8, dtype=torch.int32, device=cuda),
                            flags)
    with pytest.raises(TypeError):
        tops.sorted_probe(torch.arange(8, device=cuda),
                          torch.arange(8, device=cuda, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q15", "clickstream", "q7"])
def test_cuda_main_path_matches_eager(cuda, name):
    root, make = flows.FLOWS[name]()
    b = make(50_000, seed=2)
    cp = optimize(root).best.compile(use_kernels=True, device=cuda)
    tops.reset_launches()
    out = cp.run(b)
    assert sum(tops.LAUNCHES.values()) > 0
    ref = executor.execute(root, b)
    assert out.equivalent(ref)
    assert cp.run_device(cp.bind_device(b)).to_record_batch().equivalent(ref)
