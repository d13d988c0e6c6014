"""Device milliseconds a step of the operations launched inside the
``rollout`` span (``learn/rnad.py::rollout``)."""


def read(ctx):
    s = ctx.trace.span_s.get("rollout")
    return 1e3 * s / ctx.trace.steps if s else None
