"""roofline.segmented_scan: the segmented_scan kernel's share of its roofline in the traced
slice, in % (readers.roofline); moves rows_per_s."""

from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "segmented_scan")
