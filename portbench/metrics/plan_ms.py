"""plan_ms: host milliseconds of the optimizer and the compile in set-up
(`optimize(flow)`, `.best.compile(...)`); moves setup_s."""


def read(ctx):
    return ctx.plan_s * 1e3
