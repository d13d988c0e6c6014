"""The whole step's share of the card's peak: the step's matmul products
(``work/<family>.py``), each over its operand type's peak, over the time a
step of the unprofiled window."""


def read(ctx):
    ops_s = ctx.work.step(ctx.config, ctx.lanes, ctx.levels).ops_s()
    return 100.0 * ops_s / ctx.step_s if ops_s > 0 else None
