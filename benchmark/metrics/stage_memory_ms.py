"""Mean device ms an iteration of the recurrent policy's memory in the
rollout (rollout.memory: both LSTMs' cell step at each env step, and their
reset at done), from the stage stamps with the profiler off
(benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.ms_of(ctx, "rollout.memory")
