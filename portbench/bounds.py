"""The table of peaks and the least work of each kernel entry point.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W
power limit).  The byte counts are frozen copies of `chip_smoke.py`'s
`_compact_bytes`, `_segment_bytes`, the probe's and the segmented scan's
byte counts, so that the yardstick cannot move with the program: each
input byte read once, each output byte written once, whatever a kernel
reads again.
"""

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12      # float64 outside the tensor cores


def least_seconds(nbytes: float, f64_ops: float = 0.0) -> float:
    """The least time the chip needs for `nbytes` of device memory traffic
    and `f64_ops` float64 operations: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, f64_ops / FP64_FLOPS_PER_S)


def compact_bytes(cols, n: int, cap: int, count: int) -> int:
    """span_compact's least traffic: the mask, the rows it packs (and the
    last row, which fills the tail) read once; C slots of every column,
    the output mask and the count written once."""
    row = sum(c.element_size() * (c.numel() // max(n, 1)) for c in cols)
    moved = min(count, cap) + (1 if count < cap else 0)
    return n + moved * row + cap * (row + 1) + 8


def segment_bytes(keys, n: int, valid: int) -> int:
    """span_segment's least traffic: the mask read once, the keys (each
    distinct tensor once) of the `valid` valid rows only (an invalid slot's
    flag does not depend on its keys), seg (int64) and is_start written
    once, and the count."""
    distinct = {k.data_ptr(): k for k in keys}.values()
    return n + sum(k.element_size() for k in distinct) * valid + 8 * n + n + 8


def probe_bytes(n_keys: int, m_queries: int, key_size: int,
                out_size: int) -> int:
    """A sorted probe's least traffic: the keys and the queries read once,
    one position a query written once (int32 for sorted_probe, int64 for
    probe_positions)."""
    return n_keys * key_size + m_queries * key_size + m_queries * out_size


def reduce_bytes(values, n_segments: int, masked: bool) -> int:
    """segment_reduce's least traffic: the values, their int64 segment ids
    and the mask (when given) read once, one result a segment and column
    written once."""
    n = values.shape[0]
    cols = values.numel() // max(n, 1)
    return (values.numel() * values.element_size() + 8 * n
            + (n if masked else 0)
            + n_segments * cols * values.element_size())


def scan_bytes(values) -> int:
    """segmented_scan's least traffic: the values and one flag a row read
    once, the scanned values written once."""
    return 2 * values.numel() * values.element_size() + values.shape[0]
