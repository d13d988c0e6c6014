"""Kernel K3's share of its bound: the least time of a step's RM+ solves
(``work/kernels.py::k3_step_bound_s``: one launch a rollout turn and one
over the learner's observations) over its device time a step.  A trace
with another count of launches a step reads nothing."""

from benchmark.work import kernels


def read(ctx):
    t = ctx.trace.kernel_s("rmplus")
    steps = ctx.trace.steps
    launches = ctx.trace.kernel_launches("rmplus")
    if not t or launches != (ctx.levels + 1) * steps:
        return None
    bound = kernels.k3_step_bound_s(ctx.config, ctx.lanes, ctx.levels)
    return 100.0 * bound / (t / steps)
