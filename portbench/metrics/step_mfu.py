"""step_mfu: the whole query's share of the chip's peak, in %: the least
time the chip needs for one query's own work (bounds.least_seconds of the
bytes and float64 operations the query needs, counted from the generated
tables), times the window's queries, over the window; moves rows_per_s.
For these scan-and-probe queries the peak that binds is HBM bandwidth."""

from portbench.readers import step_mfu as read  # noqa: F401
