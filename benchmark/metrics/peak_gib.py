"""Peak device memory (``torch.cuda.max_memory_allocated``) over set-up
and the window's first episode: a fixed amount of work, read when that
episode ends."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
