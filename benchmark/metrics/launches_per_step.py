"""Kernels launched a step, counted in the trace."""


def read(ctx):
    return ctx.trace.kernels / ctx.trace.steps if ctx.trace.kernels else None
