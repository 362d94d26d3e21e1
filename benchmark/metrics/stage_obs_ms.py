"""Mean device ms an iteration of the observations and their histories
(env.obs), summed over the robots, from the stage stamps with the profiler
off (benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.ms_of(ctx, "env.obs")
