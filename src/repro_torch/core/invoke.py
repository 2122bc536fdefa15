"""Shared UDF invocation: build views, run the black box, return emissions.

Used by the eager executor, the masked executor, and the SCA dummy runs —
one code path so analysis and execution can never disagree on semantics.

A UDF runs with float64 as torch's default dtype, restored when it returns:
the reference runs its UDFs under 64-bit JAX, where `int * 0.5` and
`int / int` are float64, while torch's own default would make them float32.
The default dtype is one setting for the whole process, not one per
thread, so UDF calls are serialized: with two threads running UDFs at once
(the multi-tenant engine's pump and a regime swap's pre-trace,
`serve.dataflow`), interleaved save / set / restore steps could leave the
default at float64 for good, or drop it to float32 in the middle of a UDF.
While a UDF runs, code in other threads sees float64 as the default too.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Mapping, Sequence

import torch

from .udf import Collector, GroupView, InputView, SegmentOps

_X64_MU = threading.RLock()  # re-entrant: a UDF may run another UDF


@contextlib.contextmanager
def _x64():
    with _X64_MU:
        prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            yield
        finally:
            torch.set_default_dtype(prev)


def run_map_udf(udf, columns: Mapping[str, object]) -> Collector:
    out = Collector()
    with _x64():
        udf(InputView(columns), out)
    return out


def run_pair_udf(udf, left_cols: Mapping[str, object],
                 right_cols: Mapping[str, object]) -> Collector:
    """Cross/Match UDF over already-paired (aligned) left/right columns."""
    out = Collector()
    with _x64():
        udf(InputView(left_cols), InputView(right_cols), out)
    return out


def run_kat_udf(udf, columns_sorted: Mapping[str, object], segops: SegmentOps,
                key_fields: Sequence[str]) -> Collector:
    out = Collector()
    with _x64():
        udf(GroupView(columns_sorted, segops, key_fields), out)
    return out


def run_cogroup_udf(udf, left_sorted, left_segops, right_sorted, right_segops,
                    left_key, right_key) -> Collector:
    out = Collector()
    with _x64():
        udf(GroupView(left_sorted, left_segops, left_key),
            GroupView(right_sorted, right_segops, right_key), out)
    return out
