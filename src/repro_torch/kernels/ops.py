"""Public wrappers of the hand-written kernels: checks, dispatch, launch
counts.

Port of the `segmented_scan`, `segment_reduce`, `KernelSegmentOps`,
`sorted_probe`, `flash_attention`, `rwkv6` and `linear_scan` entries of
`repro.kernels.ops`, plus `span_compact` and `span_segment`, the megakernel
span's boundary kernels (`kernels.megakernel`).  A wrapper given CPU tensors
runs the kernel's plain torch version (`kernels.ref`); given CUDA tensors it
launches the hand-written CUDA kernel (`repro_torch/csrc/`, built on first use
by `kernels.build`) on the current stream, or raises — there is no quiet
fallback.  Every CUDA launch of a kernel adds one to `LAUNCHES[name]`, so a
run can show that its main path went through the kernels.

Unlike the reference wrappers, data-plane values keep their native dtype:
no float32 cast (`repro/kernels/ops.py:51,78`), so integer sums are exact.
The attention and recurrence kernels take any length (ragged tails are
masked or looped over), so no block size is chosen and nothing is padded.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..core.scans import scan_identity
from ..core.record import as_tensor
from ..core.udf import SegmentOps, mean_of
from . import build, ref

# CUDA launches per kernel since the last `reset_launches()`
LAUNCHES = {"sorted_probe": 0, "segmented_scan": 0, "flash_attention": 0,
            "span_compact": 0, "span_segment": 0, "rwkv6_scan": 0,
            "linear_scan": 0}

# the data plane's column types (the reference runs with 64-bit JAX)
_DTYPES = {torch.int64: 0, torch.float64: 1}
_OPS = {"add": 0, "max": 1, "min": 2}
_MAX_COLS = 4  # columns per scan (csrc/segmented_scan.cu kMaxC)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors on one card, False for CPU ones; raises on a
    mix or on any other device.  (Integer device ids: the kernels' host
    path is on the clock of small calls.)"""
    if all(t.is_cuda for t in tensors):
        dev = tensors[0].get_device()
        if all(t.get_device() == dev for t in tensors[1:]):
            return True
    elif all(t.device.type == "cpu" for t in tensors):
        return False
    raise ValueError(f"kernel inputs on unsupported or mixed devices: "
                     f"{sorted(str(t.device) for t in tensors)}")


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPES:
        raise TypeError(f"kernel does not take dtype {t.dtype}")
    return _DTYPES[t.dtype]


_raw_stream = None  # torch's raw current-stream getter, once resolved


def _stream(device) -> int:
    """The current stream of a CUDA device (a `torch.device` or its index)
    as an int, its cudaStream_t: torch's raw getter, which skips building a
    `torch.cuda.Stream`."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(device if isinstance(device, int) else device.index)


# ---------------------------------------------------------------------------
# Scratch of the look-back kernels
# ---------------------------------------------------------------------------
_scratch_bufs: dict = {}  # (kernel, device, stream) -> uint8 tensor


def _scratch(name: str, dev: int, stream: int, nbytes: int) -> torch.Tensor:
    """The scratch of kernel `name` on one device and stream, at least
    `nbytes` long.  Zeroed once when made (or grown, to twice its size at
    least) and then kept: the kernels keep it valid between calls
    themselves (tile status words carry an epoch that each launch advances
    on the card), so a call allocates and clears nothing.  Keyed by stream
    because two calls in flight must not share it."""
    key = (name, dev, stream)
    buf = _scratch_bufs.get(key)
    if buf is None or buf.numel() < nbytes:
        if buf is not None:
            nbytes = max(nbytes, 2 * buf.numel())
        buf = torch.zeros(nbytes, dtype=torch.uint8,
                          device=torch.device("cuda", dev))
        _scratch_bufs[key] = buf
    return buf


def _lookback_kernel(name: str) -> tuple:
    """(ctypes entry, rows a tile, fixed scratch bytes, scratch bytes a
    tile) of a look-back kernel, from its library's layout call."""
    lib = build.library(name)
    lay = (ctypes.c_longlong * 3)()
    getattr(lib, f"repro_{name}_layout")(lay)
    return (getattr(lib, f"repro_{name}"), *lay)


# ---------------------------------------------------------------------------
# Segmented scan / segment reduce
# ---------------------------------------------------------------------------
_scan = None  # _lookback_kernel("segmented_scan"), once built


def _launch_scan(v: torch.Tensor, op: str, out: torch.Tensor, flags=None,
                 seg_ids=None, valid=None) -> None:
    """One launch of `csrc/segmented_scan.cu` on [N >= 1, C] contiguous
    values: the scan into `out` given `flags`, or given `seg_ids` (and
    `valid`) each segment's total into `out` [num_segments, C].  At a
    Reduce's size the call's host time is on the clock, so the host path
    stays lean: the ctypes function resolved once, the raw stream, the
    scratch cached."""
    global _scan
    if _scan is None:
        _scan = _lookback_kernel("segmented_scan")
    fn, tile, fixed, per_tile = _scan
    n, c = v.shape
    if not 1 <= c <= _MAX_COLS:
        raise ValueError(f"segmented_scan takes at least 1 and at most "
                         f"{_MAX_COLS} columns, got {c}")
    code = _dtype_code(v)
    dev = v.get_device()
    stream = _stream(dev)
    buf = _scratch("segmented_scan", dev, stream,
                   fixed + per_tile * -(-n // tile))
    err = fn(code, _OPS[op], c, v.data_ptr(),
             None if flags is None else flags.data_ptr(),
             None if seg_ids is None else seg_ids.data_ptr(),
             None if valid is None else valid.data_ptr(), n,
             0 if seg_ids is None else out.shape[0], out.data_ptr(),
             buf.data_ptr(), buf.numel(), stream)
    if err:
        build.check(err, "segmented_scan")
    LAUNCHES["segmented_scan"] += 1


def segmented_scan(values: torch.Tensor, flags: torch.Tensor,
                   op: str = "add") -> torch.Tensor:
    """Inclusive segmented scan; values [N] or [N, C<=4] int64/float64,
    flags [N] bool."""
    if op not in _OPS:
        raise ValueError(op)
    if not _on_cuda(values, flags):
        return ref.segmented_scan(values, flags, op)
    squeeze = values.ndim == 1
    v = values[:, None] if squeeze else values
    if flags.shape != (v.shape[0],):
        raise ValueError(f"flags shape {tuple(flags.shape)} != ({v.shape[0]},)")
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if v.shape[0]:
        _launch_scan(v.contiguous(), op, out,
                     flags=flags.to(torch.bool).contiguous())
    return out[:, 0] if squeeze else out


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, op: str = "add",
                   valid=None) -> torch.Tensor:
    """Per-segment reduction over key-sorted rows: one launch that
    segments the rows by their ids, masks the invalid ones, writes each
    segment's last row to its id and fills the empty ids.

    Segment ids must be nondecreasing over all rows (the masked executor
    guarantees this).  Invalid rows contribute `identity_for` (0 or the
    dtype's finite min/max); empty segments hold `scan_identity`."""
    if op not in _OPS:
        raise ValueError(op)
    tensors = (values, segment_ids) + (() if valid is None else (valid,))
    if not _on_cuda(*tensors):
        return ref.segment_reduce(values, segment_ids, num_segments, op, valid)
    squeeze = values.ndim == 1
    v = values[:, None] if squeeze else values
    n = v.shape[0]
    for name, t in (("segment_ids", segment_ids), ("valid", valid)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({n},)")
    if n == 0:  # no row: every segment is empty
        out = torch.full((num_segments, v.shape[1]),
                         scan_identity(op, v.dtype), dtype=v.dtype,
                         device=v.device)
    else:
        out = torch.empty((num_segments, v.shape[1]), dtype=v.dtype,
                          device=v.device)
        _launch_scan(v.contiguous(), op, out,
                     seg_ids=segment_ids.to(torch.int64).contiguous(),
                     valid=None if valid is None
                     else valid.to(torch.bool).contiguous())
    return out[:, 0] if squeeze else out


class KernelSegmentOps(SegmentOps):
    """SegmentOps backed by the segmented-scan kernel (sorted ids); port of
    `repro.kernels.ops.KernelSegmentOps`, in the values' native dtype."""

    def __init__(self, segment_ids, num_segments: int, record_valid=None,
                 is_start=None):
        self.segment_ids = segment_ids.to(torch.int64)
        self.num_segments = int(num_segments)
        self.record_valid = record_valid
        # first valid row of each segment, precomputed by the masked executor
        # (required for order-elided inputs, where valid rows have gaps and
        # segment-id transitions no longer locate group starts)
        self.is_start = is_start

    def _tensor(self, values) -> torch.Tensor:
        return as_tensor(values, self.segment_ids.device)

    def _reduce(self, values, op):
        return segment_reduce(values, self.segment_ids, self.num_segments,
                              op=op, valid=self.record_valid)

    def sum(self, values):
        v = self._tensor(values)
        if v.dtype == torch.bool:
            v = v.to(torch.int64)
        return self._reduce(v, "add")

    def max(self, values):
        return self._reduce(self._tensor(values), "max")

    def min(self, values):
        return self._reduce(self._tensor(values), "min")

    def count(self):
        return self.sum(torch.ones_like(self.segment_ids))

    def mean(self, values):
        return mean_of(self.sum(values), self.count())

    def first(self, values):
        v = self._tensor(values)
        sid = self.segment_ids
        if self.is_start is not None:
            is_start = self.is_start
        else:
            is_start = torch.ones_like(sid, dtype=torch.bool)
            is_start[1:] = sid[1:] != sid[:-1]
            if self.record_valid is not None:
                is_start = is_start & self.record_valid
        # one slot past the domain absorbs every non-start row
        rows = torch.where(is_start, sid, self.num_segments)
        out = torch.zeros(self.num_segments + 1, dtype=v.dtype,
                          device=v.device)
        return out.scatter_(0, rows, v)[:self.num_segments]

    def any(self, mask):
        return self.sum(self._tensor(mask).to(torch.int64)) > 0

    def all(self, mask):
        return self.sum(self._tensor(mask).to(torch.int64)) == self.count()

    def broadcast(self, per_group):
        return self._tensor(per_group)[self.segment_ids]


# ---------------------------------------------------------------------------
# Sorted probe
# ---------------------------------------------------------------------------
_probe_fn = None  # the resolved ctypes function, once built


def _launch_probe(keys: torch.Tensor, q: torch.Tensor, out: torch.Tensor,
                  clamp: int, first_valid, hi: int) -> None:
    """One launch of `csrc/sorted_probe.cu` on 1-D keys and queries of one
    dtype, on the card `_on_cuda` found them on.  At a join's size the
    call's host time exceeds its device time, so the host path stays lean:
    the ctypes function resolved once, the raw stream, each check once."""
    global _probe_fn
    if _probe_fn is None:
        _probe_fn = build.library("sorted_probe").repro_sorted_probe
    if keys.ndim != 1 or q.ndim != 1:
        raise ValueError("sorted_probe takes 1-D keys and queries")
    code = _DTYPES.get(keys.dtype)
    if code is None or q.dtype != keys.dtype:
        raise TypeError(f"sorted_probe takes int64 or float64 keys and "
                        f"queries of one dtype; got {keys.dtype}, {q.dtype}")
    keys, q = keys.contiguous(), q.contiguous()
    err = _probe_fn(code, keys.data_ptr(), keys.shape[0], q.data_ptr(),
                    q.shape[0], out.data_ptr(), clamp, first_valid, hi,
                    _stream(q.get_device()))
    if err:
        build.check(err, "sorted_probe")
    LAUNCHES["sorted_probe"] += 1


def sorted_probe(keys_sorted: torch.Tensor, queries: torch.Tensor
                 ) -> torch.Tensor:
    """searchsorted(keys, queries, side='left') as int32 positions: one
    binary search per query on the card."""
    if not _on_cuda(keys_sorted, queries):
        return ref.sorted_probe(keys_sorted, queries)
    out = queries.new_empty(queries.shape[0], dtype=torch.int32)
    if out.shape[0]:
        _launch_probe(keys_sorted, queries, out, 0, None, 0)
    return out


def probe_positions(keys_sorted: torch.Tensor, queries: torch.Tensor,
                    first_valid=None, hi=None) -> torch.Tensor:
    """The join probe's int64 positions in one launch:
    clamp(maximum(searchsorted(keys, queries, side='left'), first_valid),
    0, hi), `hi` defaulting to len(keys) - 1.  `first_valid` is an int64
    0-d tensor on the keys' card, read by the kernel itself."""
    tensors = (keys_sorted, queries) if first_valid is None \
        else (keys_sorted, queries, first_valid)
    if not _on_cuda(*tensors):
        return ref.probe_positions(keys_sorted, queries, first_valid, hi)
    if first_valid is not None and (first_valid.dtype != torch.int64
                                    or first_valid.numel() != 1):
        raise TypeError(f"first_valid must be one int64, got "
                        f"{first_valid.dtype} {tuple(first_valid.shape)}")
    out = queries.new_empty(queries.shape[0], dtype=torch.int64)
    if out.shape[0]:
        _launch_probe(keys_sorted, queries, out, 1,
                      None if first_valid is None else first_valid.data_ptr(),
                      keys_sorted.shape[0] - 1 if hi is None else int(hi))
    return out


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------
_ATTN_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (32, 64, 128)


def _row_strided(x: torch.Tensor) -> bool:
    """The kernels' layout: head dim contiguous, the base and every
    (batch, head, row) stride of a dimension longer than 1 16-byte
    aligned."""
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(x.shape[i] == 1 or x.stride(i) * x.element_size() % 16 == 0
                    for i in range(3)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None, scale=None
                    ) -> torch.Tensor:
    """Causal / sliding-window GQA attention, q [B,Hq,T,D] and k/v
    [B,Hkv,S,D] -> [B,Hq,T,D] in q's dtype: one launch of the CUDA kernel
    (`csrc/flash_attention.cu`).  On the card it takes bf16 or float32
    tensors with D in (32, 64, 128) and a window of at least 1.  bf16
    operands may be row-strided views (head dim contiguous, strides and
    base 16-byte aligned), such as [B,T,H,D] memory viewed as [B,H,T,D],
    and the bf16 output is [B,T,Hq,D] memory viewed as [B,Hq,T,D].  float32
    operands are made contiguous."""
    if not _on_cuda(q, k, v):
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q [B,Hq,T,D] and k, v "
                         f"[B,Hkv,S,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"make a GQA pair")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {_HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _ATTN_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or float32 q, k, v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention takes a window >= 1, got {window}")
    if max(b, hq, t, s) >= 2**31:
        raise ValueError("flash_attention sizes must fit in int32")
    if q.dtype == torch.float32:  # the f32 kernel takes contiguous tensors
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty_like(q)
    else:  # [B,T,Hq,D] memory: the caller's transpose back is a view
        out = torch.empty((b, t, hq, d), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not _row_strided(x):
            raise ValueError(f"flash_attention needs {name} with a "
                             f"contiguous head dim and 16-byte aligned "
                             f"rows; got strides {x.stride()}")
    if out.numel() == 0:
        return out
    # a window of S or more masks nothing the kernel could see
    win = -1 if window is None or window >= s else int(window)
    strides = (ctypes.c_longlong * 12)(*(x.stride(i) for x in (q, k, v, out)
                                         for i in range(3)))
    lib = build.library("flash_attention")
    err = lib.repro_flash_attention(
        _ATTN_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, hq, hkv, t, s, strides,
        float(scale) if scale is not None else d ** -0.5, int(bool(causal)),
        win, _stream(q.device))
    build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# Megakernel span: boundary compaction and contiguous segmentation
# ---------------------------------------------------------------------------
_SPAN_MAX_K = 8  # keys span_segment compares without a flag pass (kMaxK)
# span_segment key kinds (csrc/span_segment.cu): integers by width, floats
# compared as IEEE values
_KEY_KINDS = {torch.int64: 0, torch.int32: 1, torch.int16: 2, torch.int8: 3,
              torch.uint8: 3, torch.bool: 3, torch.float64: 4,
              torch.float32: 5}


def _ptrs(tensors) -> "ctypes.Array":
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[t.data_ptr() for t in tensors])


def _ints(values) -> "ctypes.Array":
    return (ctypes.c_int * max(len(values), 1))(*values)


def _span_check(name: str, tensors, valid: torch.Tensor) -> None:
    if valid.ndim != 1 or valid.dtype != torch.bool:
        raise TypeError(f"{name} takes a 1-D bool mask, got "
                        f"{valid.dtype} {tuple(valid.shape)}")
    if valid.shape[0] < 1:
        raise ValueError(f"{name} takes at least one row")
    for t in tensors:
        if t.ndim < 1 or t.shape[0] != valid.shape[0]:
            raise ValueError(f"{name}: column {tuple(t.shape)} against a "
                             f"mask of {valid.shape[0]} rows")


_compact = None  # _lookback_kernel("span_compact"), once built
_tls = threading.local()  # a reused column-descriptor buffer per thread


def _descriptors(k: int) -> "ctypes.Array":
    """This thread's descriptor buffer (four int64 words a column), grown
    when needed and otherwise reused."""
    buf = getattr(_tls, "desc", None)
    if buf is None or len(buf) < 4 * k:
        buf = (ctypes.c_longlong * max(4 * k, 128))()
        _tls.desc = buf
    return buf


def span_compact(columns, valid: torch.Tensor, capacity: int):
    """Stable valids-first pack of `columns` and `valid` into `capacity`
    slots: `(columns', valid', count)`, bit for bit `MaskedBatch.compact`
    (slots past the count hold the last input row) plus the
    pre-compaction valid count (int64, 0-d).  One launch of
    `csrc/span_compact.cu` on the card for up to 32 columns (one per group
    of 32 past that); columns of any type move as raw words."""
    global _compact
    columns = list(columns)
    if not _on_cuda(valid, *columns):
        return ref.span_compact(columns, valid, capacity)
    _span_check("span_compact", columns, valid)
    if capacity < 1:
        raise ValueError(f"span_compact capacity {capacity} < 1")
    if _compact is None:
        _compact = _lookback_kernel("span_compact")
    fn, tile, fixed, per_tile = _compact
    dev, n = valid.get_device(), valid.shape[0]
    valid = valid.contiguous()
    desc = _descriptors(len(columns))
    ins, outs = [], []
    for j, c in enumerate(columns):
        c = c.contiguous()
        row = c.element_size() * (c.numel() // n)
        ptr = c.data_ptr()
        w = next(w for w in (8, 4, 2, 1) if row % w == 0 and ptr % w == 0)
        o = torch.empty((capacity,) + tuple(c.shape[1:]), dtype=c.dtype,
                        device=c.device)
        desc[4 * j:4 * j + 4] = (ptr, o.data_ptr(), w, row // w)
        ins.append(c)
        outs.append(o)
    valid_out = torch.empty(capacity, dtype=torch.bool, device=valid.device)
    count = torch.empty((), dtype=torch.int64, device=valid.device)
    stream = _stream(dev)
    buf = _scratch("span_compact", dev, stream,
                   fixed + per_tile * -(-n // tile))
    src = _scratch("span_compact_src", dev, stream, 8 * capacity)
    err = fn(valid.data_ptr(), n, len(columns), desc, capacity,
             valid_out.data_ptr(), count.data_ptr(), buf.data_ptr(),
             buf.numel(), src.data_ptr(), stream)
    if err:
        build.check(err, "span_compact")
    LAUNCHES["span_compact"] += 1
    return outs, valid_out, count


def span_segment(keys, valid: torch.Tensor):
    """Segments of a packed, key-ordered batch: `(seg, is_start, count)`,
    bit for bit `masked._segments_contiguous` plus the group count (int64,
    0-d).  One launch of `csrc/span_segment.cu` on the card; keys are 1-D
    integer, bool, float32 or float64 columns, any number of them (past 8
    the kernel first folds them into one difference flag a slot)."""
    keys = list(keys)
    if not _on_cuda(valid, *keys):
        return ref.span_segment(keys, valid)
    _span_check("span_segment", keys, valid)
    for k in keys:
        if k.ndim != 1 or k.dtype not in _KEY_KINDS:
            raise TypeError(f"span_segment takes 1-D keys of "
                            f"{sorted(str(d) for d in _KEY_KINDS)}, got "
                            f"{k.dtype} {tuple(k.shape)}")
    dev, n = valid.device, valid.shape[0]
    valid = valid.contiguous()
    keys = [k.contiguous() for k in keys]
    seg = torch.empty(n, dtype=torch.int64, device=dev)
    is_start = torch.empty(n, dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    flags = (torch.empty(n, dtype=torch.uint8, device=dev)
             if len(keys) > _SPAN_MAX_K else None)
    lib = build.library("span_segment")
    scratch = torch.empty(lib.repro_span_segment_scratch(n),
                          dtype=torch.int64, device=dev)
    err = lib.repro_span_segment(
        len(keys), _ptrs(keys), _ints([_KEY_KINDS[k.dtype] for k in keys]),
        valid.data_ptr(), n, seg.data_ptr(), is_start.data_ptr(),
        None if flags is None else flags.data_ptr(), scratch.data_ptr(),
        count.data_ptr(), _stream(dev))
    build.check(err, "span_segment")
    LAUNCHES["span_segment"] += 1
    return seg, is_start, count


# ---------------------------------------------------------------------------
# RWKV-6 and RG-LRU recurrences
# ---------------------------------------------------------------------------
_SCAN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_RWKV_DK = (16, 32, 64, 128)
_RWKV_MAX_DV = 256  # csrc/rwkv6_scan.cu kMaxDv


def _contiguous(name: str, **tensors) -> None:
    for arg, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} needs {arg} contiguous")


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor, state=None,
          return_state: bool = False):
    """The WKV6 recurrence: r, k, w [B,H,T,Dk], v [B,H,T,Dv], u [H,Dk] ->
    out [B,H,T,Dv] in r's dtype, and with `return_state` the final state
    [B,H,Dk,Dv] float32; `state` (the same shape, float32) is the initial
    one.  One launch of `csrc/rwkv6_scan.cu` on the card; it reads r, k, v
    (one dtype), w and u each in its own dtype (bf16 or float32), takes any
    T, Dk in (16, 32, 64, 128) and Dv a multiple of 8 up to 256, all
    contiguous and 16-byte aligned."""
    tensors = (r, k, v, w, u) + (() if state is None else (state,))
    if not _on_cuda(*tensors):
        return ref.rwkv6(r, k, v, w, u, state=state,
                         return_state=return_state)
    if r.ndim != 4 or k.shape != r.shape or w.shape != r.shape \
            or v.ndim != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"rwkv6 takes r, k, w [B,H,T,Dk] and v [B,H,T,Dv]; "
                         f"got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if u.shape != (h, dk):
        raise ValueError(f"rwkv6 takes u [H,Dk] = ({h}, {dk}), got "
                         f"{tuple(u.shape)}")
    if state is not None and (state.shape != (b, h, dk, dv)
                              or state.dtype != torch.float32):
        raise ValueError(f"rwkv6 takes a float32 state [B,H,Dk,Dv] = "
                         f"({b}, {h}, {dk}, {dv}), got {state.dtype} "
                         f"{tuple(state.shape)}")
    if dk not in _RWKV_DK or dv % 8 or not 8 <= dv <= _RWKV_MAX_DV:
        raise ValueError(f"rwkv6 takes Dk in {_RWKV_DK} and Dv a multiple "
                         f"of 8 up to {_RWKV_MAX_DV}, got Dk={dk}, Dv={dv}")
    for name, x in (("r", r), ("w", w), ("u", u)):
        if x.dtype not in _SCAN_DTYPES:
            raise TypeError(f"rwkv6 takes bf16 or float32 {name}, got "
                            f"{x.dtype}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6 takes r, k, v of one dtype, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    _contiguous("rwkv6", r=r, k=k, v=v, w=w, u=u,
                **({} if state is None else {"state": state}))
    if any(x.data_ptr() % 16 for x in (r, k, v, w)):
        raise ValueError("rwkv6 needs r, k, v, w 16-byte aligned")
    if max(b * h, t) >= 2**31:
        raise ValueError("rwkv6 sizes must fit in int32")
    out = torch.empty((b, h, t, dv), dtype=r.dtype, device=r.device)
    s_out = (torch.empty((b, h, dk, dv), dtype=torch.float32,
                         device=r.device) if return_state else None)
    if b * h:
        lib = build.library("rwkv6_scan")
        err = lib.repro_rwkv6_scan(
            dk, *(_SCAN_DTYPES[x.dtype] for x in (r, w, u)),
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            None if s_out is None else s_out.data_ptr(), out.data_ptr(),
            b * h, h, t, dv, _stream(r.device))
        build.check(err, "rwkv6_scan")
        LAUNCHES["rwkv6_scan"] += 1
    return (out, s_out) if return_state else out


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t over axis -2: a, b [..., T, D] float32 ->
    h [..., T, D] float32; `h0` [..., D] float32 enters as h_{-1} (the
    reference's fold b_0 += a_0·h0).  One launch of `csrc/linear_scan.cu`
    on the card, on contiguous tensors of any T."""
    tensors = (a, b) + (() if h0 is None else (h0,))
    if not _on_cuda(*tensors):
        return ref.linear_scan(a, b, h0=h0)
    if a.ndim < 2 or b.shape != a.shape:
        raise ValueError(f"linear_scan takes a, b [..., T, D] of one shape, "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}")
    lead, t, d = a.shape[:-2], a.shape[-2], a.shape[-1]
    if h0 is not None and h0.shape != lead + (d,):
        raise ValueError(f"linear_scan takes h0 {tuple(lead + (d,))}, got "
                         f"{tuple(h0.shape)}")
    for name, x in (("a", a), ("b", b)) + (() if h0 is None
                                           else (("h0", h0),)):
        if x.dtype != torch.float32:
            raise TypeError(f"linear_scan takes float32 {name}, got "
                            f"{x.dtype}")
    _contiguous("linear_scan", a=a, b=b,
                **({} if h0 is None else {"h0": h0}))
    g = a.numel() // max(t * d, 1)
    if g > 65535 or d >= 2**31:
        raise ValueError(f"linear_scan takes at most 65,535 sequences of "
                         f"fewer than 2**31 channels, got {g} of {d}")
    out = torch.empty_like(a)
    if out.numel():
        lib = build.library("linear_scan")
        err = lib.repro_linear_scan(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), out.data_ptr(), g, t, d,
            _stream(a.device))
        build.check(err, "linear_scan")
        LAUNCHES["linear_scan"] += 1
    return out
