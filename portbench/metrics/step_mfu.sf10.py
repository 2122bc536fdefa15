"""step_mfu.sf10: step_mfu in the SF10 cell; moves rows_per_s.sf10."""

from portbench.readers import step_mfu as read  # noqa: F401
