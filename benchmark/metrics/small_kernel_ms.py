"""Device ms of every kernel that is neither hand-written (hgt_*) nor a
matmul in one profiled iteration: the env step, rewards, terrain patches
and the trainer's elementwise, gather and reduction kernels."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else tr.class_s("small") / tr.iters * 1e3
