"""Set-up: process start to the window (imports, the deck, mesh and FE
space, multigrid levels, the kernel libraries, the warm steps)."""


def read(ctx):
    return ctx.setup_s
