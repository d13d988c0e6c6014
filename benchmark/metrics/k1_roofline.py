"""Kernel K1's share of its bound: the least time of its launches a step
(``work/kernels.py::k1_step``, from the distinct states and played cells
of the traced steps' rollouts) over its device time a step."""

from benchmark.work import kernels


def read(ctx):
    t = ctx.trace.kernel_s("fused_turn")
    if not t or not ctx.rollouts:
        return None
    rows, cells = ctx.distinct()
    bound = kernels.k1_step(ctx.config, ctx.lanes, ctx.levels, rows,
                            cells).bound_s()
    return 100.0 * bound / (t / ctx.trace.steps)
