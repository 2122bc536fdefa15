"""device_idle: the share of the traced slice in which no operation ran on
the device, in %: 1 - union of the device intervals / the slice; moves
rows_per_s."""

from portbench.readers import device_idle as read  # noqa: F401
