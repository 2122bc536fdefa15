"""roofline.sorted_probe: the sorted_probe kernel's share of its roofline in the traced
slice, in % (readers.roofline); moves rows_per_s."""

from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "sorted_probe")
