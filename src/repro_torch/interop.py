"""Carrying data between the reference package and the port.

This system has no weights: its state is the bound data.  Both packages
bind sources as `{source: RecordBatch}` and a `RecordBatch` holds numpy
columns, so numpy dictionaries are the common currency.  `bindings` turns
`{source: {field: np.ndarray}}` (what the reference's
`RecordBatch.columns` hold) into the port's bindings; `columns` turns a
port result — a `RecordBatch` or a device-resident `MaskedBatch` — back
into `{field: np.ndarray}` of its valid rows.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .core.masked import MaskedBatch
from .core.record import RecordBatch, as_numpy


def bindings(data: Mapping[str, Mapping[str, np.ndarray]]
             ) -> dict[str, RecordBatch]:
    """`{source: {field: array}}` -> the port's `{source: RecordBatch}`
    (columns copied, so later edits of `data` do not leak in)."""
    return {src: RecordBatch({f: np.array(v, copy=True)
                              for f, v in cols.items()})
            for src, cols in data.items()}


def columns(result) -> dict[str, np.ndarray]:
    """The valid rows of a port result as `{field: np.ndarray}`."""
    if isinstance(result, MaskedBatch):
        result = result.to_record_batch()
    b = result.to_numpy().compact()
    return {f: as_numpy(v) for f, v in b.columns.items()}
