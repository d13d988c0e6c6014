"""The device's idle share of a step: one less the trace's busy time a
step (the union of its operations' intervals) over the time a step of the
same run's unprofiled window, which the profiler does not slow."""


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.steps / ctx.step_s)
