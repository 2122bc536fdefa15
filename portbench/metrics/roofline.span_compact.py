"""roofline.span_compact: the span_compact kernel's share of its roofline in the traced
slice, in % (readers.roofline); moves rows_per_s.sf10."""

from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "span_compact")
