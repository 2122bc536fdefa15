"""device_idle.sf10: device_idle in the SF10 cell; moves rows_per_s.sf10."""

from portbench.readers import device_idle as read  # noqa: F401
