"""Record data model for the PACT-style data-flow plane.

The paper defines a data set as an unordered list of records, a record as an
ordered tuple of values, and a *global record* as a unique naming of all base
and intermediate attributes (Def. 1).  We realise data sets as struct-of-array
`RecordBatch`es (one array per attribute) with an optional validity mask, so
flows can also run on the device with static shapes.  Port of
`repro.core.record`: columns are numpy arrays or torch tensors (on any
device); eager paths normalise to numpy.

Attributes are identified by globally-unique string names; the flow builder
enforces uniqueness (auto-renaming on collision), which plays the role of the
paper's redirection map alpha(D, n).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

import torch


def as_numpy(x) -> np.ndarray:
    """A column as a host numpy array (torch tensors are copied off their
    device; numpy arrays and scalars pass through `np.asarray`)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cpu_tensor(a) -> torch.Tensor:
    """A host column as a CPU tensor (zero-copy where numpy allows it)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def as_tensor(x, device=None) -> torch.Tensor:
    """A column or scalar as a tensor on `device`.  Values that are not yet
    tensors go through numpy first, so Python floats become float64 (the
    reference's float) rather than torch's default float32."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, device=device)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  "cuda" is the default of every
    entry point; asking for it without a CUDA device raises — nothing
    drops to the CPU unless the caller passes `device="cpu"`."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if d.index is None:  # "cuda" names the current card, as tensors do
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype (schemas keep numpy dtypes)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dt))).dtype


@dataclasses.dataclass(frozen=True)
class Schema:
    """Ordered attribute names with dtypes."""

    fields: tuple[str, ...]
    dtypes: Mapping[str, np.dtype]

    @staticmethod
    def of(**name_to_dtype) -> "Schema":
        return Schema(tuple(name_to_dtype), {k: np.dtype(v) for k, v in name_to_dtype.items()})

    def __contains__(self, name: str) -> bool:
        return name in self.fields

    def dtype(self, name: str) -> np.dtype:
        return np.dtype(self.dtypes[name])

    def width_bytes(self) -> int:
        """Bytes per record (sum of field itemsizes)."""
        return int(sum(np.dtype(self.dtypes[f]).itemsize for f in self.fields))

    def project(self, names: Sequence[str]) -> "Schema":
        return Schema(tuple(names), {n: self.dtypes[n] for n in names})

    def extend(self, **name_to_dtype) -> "Schema":
        d = dict(self.dtypes)
        fields = list(self.fields)
        for k, v in name_to_dtype.items():
            if k not in d:
                fields.append(k)
            d[k] = np.dtype(v)
        return Schema(tuple(fields), d)

    def union(self, other: "Schema") -> "Schema":
        overlap = set(self.fields) & set(other.fields)
        if overlap:
            raise ValueError(f"schema union collision on {sorted(overlap)}")
        d = dict(self.dtypes)
        d.update(other.dtypes)
        return Schema(tuple(self.fields) + tuple(other.fields), d)

    def rename(self, mapping: Mapping[str, str]) -> "Schema":
        fields = tuple(mapping.get(f, f) for f in self.fields)
        return Schema(fields, {mapping.get(k, k): v for k, v in self.dtypes.items()})


class RecordBatch:
    """A batch of records: one array per attribute plus a validity mask.

    `valid is None` means "all rows valid" (eager mode keeps batches compact);
    device mode always carries an explicit mask and a static capacity.
    """

    __slots__ = ("columns", "valid", "_n")

    def __init__(self, columns: Mapping[str, object], valid=None):
        if not columns:
            raise ValueError("RecordBatch needs at least one column")
        self.columns = dict(columns)
        lengths = {v.shape[0] if isinstance(v, torch.Tensor) else np.shape(v)[0]
                   for v in self.columns.values()}
        if len(lengths) != 1:
            raise ValueError(f"ragged columns: {lengths}")
        self._n = lengths.pop()
        self.valid = valid

    # -- basic introspection ------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._n

    def num_valid(self) -> int:
        if self.valid is None:
            return self._n
        return int(as_numpy(self.valid).sum())

    @property
    def fields(self) -> tuple[str, ...]:
        return tuple(self.columns)

    def schema(self) -> Schema:
        return Schema(
            tuple(self.columns),
            {k: as_numpy(v[:0]).dtype if not isinstance(v, np.ndarray) else v.dtype
             for k, v in self.columns.items()},
        )

    def __getitem__(self, name: str):
        return self.columns[name]

    # -- transforms (eager, numpy semantics) --------------------------------
    def to_numpy(self) -> "RecordBatch":
        cols = {k: as_numpy(v) for k, v in self.columns.items()}
        valid = None if self.valid is None else as_numpy(self.valid)
        return RecordBatch(cols, valid)

    def compact(self) -> "RecordBatch":
        """Drop invalid rows (eager/host mode only — dynamic shape)."""
        if self.valid is None:
            return self
        mask = as_numpy(self.valid)
        cols = {k: as_numpy(v)[mask] for k, v in self.columns.items()}
        return RecordBatch(cols, None)

    def take(self, idx) -> "RecordBatch":
        cols = {k: as_numpy(v)[idx] for k, v in self.columns.items()}
        valid = None if self.valid is None else as_numpy(self.valid)[idx]
        return RecordBatch(cols, valid)

    def project(self, names: Sequence[str]) -> "RecordBatch":
        return RecordBatch({n: self.columns[n] for n in names}, self.valid)

    def rename(self, mapping: Mapping[str, str]) -> "RecordBatch":
        return RecordBatch({mapping.get(k, k): v for k, v in self.columns.items()}, self.valid)

    @staticmethod
    def concat_rows(batches: Sequence["RecordBatch"]) -> "RecordBatch":
        fields = batches[0].fields
        cols = {f: np.concatenate([as_numpy(b.columns[f]) for b in batches]) for f in fields}
        if any(b.valid is not None for b in batches):
            valid = np.concatenate(
                [as_numpy(b.valid) if b.valid is not None else np.ones(b.capacity, bool)
                 for b in batches])
        else:
            valid = None
        return RecordBatch(cols, valid)

    # -- canonical comparison (data sets are unordered: Sec. 2.2) -----------
    def sorted_tuples(self) -> list[tuple]:
        """Valid rows as a lexicographically sorted list of tuples (multiset
        equality check used by the safety property tests)."""
        b = self.to_numpy().compact()
        rows = list(zip(*[np.asarray(b.columns[f]).tolist() for f in b.fields]))
        return sorted(rows, key=lambda t: tuple(repr(x) for x in t))

    def equivalent(self, other: "RecordBatch", atol: float = 1e-5) -> bool:
        """Multiset equality of valid rows (order-insensitive, Def of D1 == D2)."""
        a, b = self.to_numpy().compact(), other.to_numpy().compact()
        if set(a.fields) != set(b.fields) or a.capacity != b.capacity:
            return False
        fields = sorted(a.fields)
        am = np.stack([np.asarray(a.columns[f], dtype=np.float64) for f in fields], 1)
        bm = np.stack([np.asarray(b.columns[f], dtype=np.float64) for f in fields], 1)
        am = am[np.lexsort(am.T[::-1])]
        bm = bm[np.lexsort(bm.T[::-1])]
        return am.shape == bm.shape and bool(np.allclose(am, bm, atol=atol))

    def __repr__(self) -> str:  # pragma: no cover
        return f"RecordBatch(n={self.num_valid()}/{self.capacity}, fields={list(self.fields)})"


def batch_from_dict(d: Mapping[str, Sequence], valid=None) -> RecordBatch:
    return RecordBatch({k: as_numpy(v) for k, v in d.items()}, valid)
