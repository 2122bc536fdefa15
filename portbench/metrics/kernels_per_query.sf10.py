"""kernels_per_query.sf10: kernels_per_query in the SF10 cell; moves
rows_per_s.sf10."""

from portbench.readers import kernels_per_query as read  # noqa: F401
