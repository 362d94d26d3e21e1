"""Host seconds of loading the kernel library (csrc/, built into
build/kernels/ by a cell's first run and loaded from there after)."""


def read(ctx):
    return ctx.get("setup_build_s")
