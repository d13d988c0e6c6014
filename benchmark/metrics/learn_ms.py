"""Device milliseconds a step of the operations launched inside the
``learn_step`` span (``learn/rnad.py::learn_step``: the learner and
frozen passes, v-trace, the losses, the backward, clip + Adam + EMA)."""


def read(ctx):
    s = ctx.trace.span_s.get("learn_step")
    return 1e3 * s / ctx.trace.steps if s else None
