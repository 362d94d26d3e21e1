"""Mean device ms an iteration of the reward terms and the feet state
(env.rewards), summed over the robots, from the stage stamps with the
profiler off (benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.ms_of(ctx, "env.rewards")
