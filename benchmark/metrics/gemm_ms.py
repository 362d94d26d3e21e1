"""Device ms of the matmul kernels (cuBLAS / CUTLASS, by name) in one
profiled iteration: the nets' forward and backward passes."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else tr.class_s("matmul") / tr.iters * 1e3
