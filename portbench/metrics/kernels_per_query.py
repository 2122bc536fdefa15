"""kernels_per_query: device operations in the traced slice over its
queries; moves rows_per_s."""

from portbench.readers import kernels_per_query as read  # noqa: F401
