"""The share of the window's mean iteration (host clock, dispatch to
dispatch) in which the card was not running the iteration: 1 - the median
single replay (CUDA events, profiler off) / the window's mean iteration, in
%. It is the host's hold on the card, read without the profiler, whose own
buffer flushes stall replays of ~100k kernels."""

import statistics


def read(ctx):
    ms = ctx.get("replay_ms")
    if not ms or ctx["device"].type != "cuda":
        return None
    return (1.0 - statistics.median(ms) / (ctx["window_s"] / ctx["window_iters"] * 1e3)) * 100.0
