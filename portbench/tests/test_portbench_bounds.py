"""The frozen byte counts reproduce chip_smoke.py's logged bounds."""

import torch

from portbench import bounds


def _ms(nbytes):
    return round(bounds.least_seconds(nbytes) * 1e3, 4)


def test_compact_bytes_match_the_logged_bound():
    # span_compact at q15's first boundary, 6M rows: bound_ms 0.0120
    n, cap, count = 8_388_608, 1_048_576, 239_603
    cols = [torch.empty(n, dtype=d, device="meta")
            for d in (torch.int64, torch.float64, torch.float64)]
    assert _ms(bounds.compact_bytes(cols, n, cap, count)) == 0.0120


def test_segment_bytes_match_the_logged_bound():
    # span_segment at q15's in-span Reduce: bound_ms 0.0037
    keys = [torch.zeros(1_048_576, dtype=torch.int64)]
    assert _ms(bounds.segment_bytes(keys, 1_048_576, 239_603)) == 0.0037


def test_reduce_and_probe_bytes_match_the_logged_bounds():
    # segment_reduce add over 1,048,576 float64 rows and segments: 0.0078;
    # sorted_probe of 32,768 int64 queries into 16,384 keys: 0.000157
    v = torch.empty(1_048_576, dtype=torch.float64, device="meta")
    assert _ms(bounds.reduce_bytes(v, 1_048_576, masked=True)) == 0.0078
    probe = bounds.probe_bytes(16_384, 32_768, 8, 4)
    assert round(bounds.least_seconds(probe) * 1e3, 6) == 0.000157


def test_least_seconds_takes_the_larger_bound():
    assert bounds.least_seconds(3.35e12, 0) == 1.0
    assert bounds.least_seconds(0, 34e12) == 1.0
    assert bounds.least_seconds(3.35e12, 68e12) == 2.0
