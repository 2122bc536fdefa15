"""The trace's reductions and the roofline reader, on made-up readings."""

from portbench import readers, trace
from portbench.readers import Context


def test_union_merges_overlaps():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union([]) == 0


def _ctx(entry_calls, trace_calls, seconds=0.001):
    t = trace.Trace(queries=2, window_s=0.01, busy_s=0.005, device_ops=10,
                    entry_s={"span_compact": seconds},
                    entry_calls=trace_calls)
    return Context(plan_s=0.0, dispatch_s=[], queries=2, window_s=1.0,
                   least_s=0.0, trace=t, entry_bytes={"span_compact": 1675000},
                   entry_calls=entry_calls)


def test_roofline_reads_bytes_over_device_time():
    ctx = _ctx({"span_compact": 1}, {"span_compact": 2})
    # 2 x 1,675,000 bytes at 3.35 TB/s = 1 us, over 1 ms of device time
    assert abs(readers.roofline(ctx, "span_compact") - 0.1) < 1e-9


def test_roofline_is_silent_without_matching_calls():
    assert readers.roofline(_ctx({"span_compact": 1}, {"span_compact": 3}),
                            "span_compact") is None
    assert readers.roofline(_ctx({}, {}), "span_compact") is None
    assert readers.roofline(_ctx({"span_compact": 1}, {"span_compact": 2},
                                 seconds=0.0), "span_compact") is None
