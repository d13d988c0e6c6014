"""Seconds from the start of the process to the first timed step:
imports, the CUDA context, the tree, the nets, the kernels' build or load
and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
