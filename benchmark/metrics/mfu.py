"""The whole iteration's share of the card's peak, in %: the least time
its work needs (census.iteration_least_s: float32 physics and GAE at 67
TFLOP/s, the nets' matmuls at 989 TFLOP/s bf16) over the window's mean
iteration time."""

from benchmark import census


def read(ctx):
    if ctx["device"].type != "cuda":
        return None
    cfg = dict(ctx["config"], steps_per_env=ctx["steps_per_env"])
    least = census.iteration_least_s(cfg, ctx["envs_per_robot"])
    return least / (ctx["window_s"] / ctx["window_iters"]) * 100.0
