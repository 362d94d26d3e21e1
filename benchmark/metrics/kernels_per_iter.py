"""Device kernels in one profiled iteration (a count)."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else len(tr.kernels) / tr.iters
