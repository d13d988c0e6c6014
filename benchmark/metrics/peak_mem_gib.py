"""Peak of the memory the program allocated on the card over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(ctx):
    return ctx.window.peak_bytes / 2**30
