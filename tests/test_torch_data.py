"""The port's training input pipeline and input shapes against the
reference: `data.pipeline` (`corpus_flow`, `TokenPipeline`) and
`configs.shapes`.

The pipeline's tokens must equal the reference's exactly: both optimize
the same corpus flow with `Ctx(dop=32), include_commutes=False`, run the
chosen plan on the eager host executor over the same numpy-seeded
bindings, and draw each token row from the same per-row numpy generator,
so any difference in the chosen plan or in the order of the executor's
rows shows as other tokens.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget
from repro.configs import shapes as jshapes
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.data.pipeline import corpus_flow as jcorpus_flow
from repro.core import executor as jexecutor
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import executor
from repro_torch.data.pipeline import TokenPipeline, corpus_flow

# (vocab, batch, seq, seed, docs_per_step); 8 docs leave fewer surviving
# records than the batch, so the rows are cycled
PIPES = {
    "small": (128, 4, 16, 3, 512),
    "qwen3": (151_936, 8, 512, 0, 4096),
    "cycled": (512, 8, 8, 1, 8),
}


@pytest.fixture(scope="module")
def pipes():
    return {name: (JTokenPipeline(vocab=v, batch=b, seq=s, seed=seed,
                                  docs_per_step=d),
                   TokenPipeline(vocab=v, batch=b, seq=s, seed=seed,
                                 docs_per_step=d, device="cpu"))
            for name, (v, b, s, seed, d) in PIPES.items()}


def test_plan_order_matches_reference(pipes):
    for name, (jp, tp) in pipes.items():
        assert tp.optimized.best.order() == jp.optimized.best.order()
    assert tp.optimized.best.order() == (
        "domains->DomainWeight->docs->QualityFilter->Dedup->DomainJoin")


@pytest.mark.parametrize("name", list(PIPES))
@pytest.mark.parametrize("step", [0, 1, 11, 1000])
def test_tokens_equal_reference(pipes, name, step):
    jp, tp = pipes[name]
    got = tp(step)["tokens"]
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert got.shape == (jp.batch, jp.seq)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jp(step)["tokens"]))


def test_executor_rows_in_reference_order():
    """The batch takes the first rows of the eager result: the port's rows
    come in the reference's order, field by field."""
    jroot, jbind = jcorpus_flow()
    troot, tbind = corpus_flow()
    jp = JTokenPipeline(vocab=64, batch=2, seq=4)
    tp = TokenPipeline(vocab=64, batch=2, seq=4, device="cpu")
    for seed in (0, 7):
        want = jexecutor.execute(jp.best_flow, jbind(2048, seed))
        got = interop.columns(executor.execute(tp.best_flow,
                                               tbind(2048, seed)))
        assert set(got) == set(want.columns)
        for f, col in want.columns.items():
            np.testing.assert_array_equal(got[f], np.asarray(col))
    # the unoptimized flow gives the same multiset in another order
    assert executor.execute(troot, tbind(2048, 0)).equivalent(
        executor.execute(tp.best_flow, tbind(2048, 0)))


def test_pipeline_deterministic_and_step_dependent():
    p1 = TokenPipeline(vocab=128, batch=4, seq=16, seed=3,
                       docs_per_step=512, device="cpu")
    p2 = TokenPipeline(vocab=128, batch=4, seq=16, seed=3,
                       docs_per_step=512, device="cpu",
                       optimized=p1.optimized)
    assert torch.equal(p1(11)["tokens"], p2(11)["tokens"])
    assert not torch.equal(p1(11)["tokens"], p1(12)["tokens"])
    p3 = TokenPipeline(vocab=128, batch=4, seq=16, seed=4,
                       docs_per_step=512, device="cpu")
    assert not torch.equal(p1(11)["tokens"], p3(11)["tokens"])


def test_pipeline_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(vocab=64, batch=2, seq=4)


def test_shapes_match_reference():
    assert set(tconfigs.SHAPES) == set(jshapes.SHAPES)
    for k, spec in tconfigs.SHAPES.items():
        j = jshapes.SHAPES[k]
        assert (spec.name, spec.kind, spec.seq, spec.batch) == (
            j.name, j.kind, j.seq, j.batch)
    assert tconfigs.shapes.LONG_OK_FAMILIES == jshapes.LONG_OK_FAMILIES


@pytest.mark.parametrize("reduced", [False, True])
def test_long_ok_and_shapes_for_every_arch(reduced):
    assert ARCH_IDS == J_ARCH_IDS
    longs = []
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch, reduced=reduced), jget(arch,
                                                            reduced=reduced)
        assert tconfigs.long_ok(cfg) == jshapes.long_ok(jcfg)
        assert tconfigs.shapes_for(cfg) == jshapes.shapes_for(jcfg)
        if tconfigs.long_ok(cfg):
            longs.append(arch)
    assert longs == ["rwkv6-3b", "mixtral-8x22b", "recurrentgemma-2b"]
