"""The median device ms of single training iterations through the
runner's captured call after the window, each alone between CUDA events."""

import statistics


def read(ctx):
    ms = ctx.get("replay_ms")
    if not ms or ctx["device"].type != "cuda":
        return None
    return statistics.median(ms)
