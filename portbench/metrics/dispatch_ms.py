"""dispatch_ms: the median host milliseconds from the call of
`CompiledPlan.run_device` to its return, before the synchronise, over the
window's queries; moves query_ms.p95."""

from portbench.readers import median_ms


def read(ctx):
    return median_ms(ctx.dispatch_s)
