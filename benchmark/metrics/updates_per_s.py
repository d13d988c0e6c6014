"""Learner updates completed in the window over its host seconds, from a
synchronize to a synchronize, every launch included."""


def read(ctx):
    return ctx.window.steps / ctx.window.seconds
