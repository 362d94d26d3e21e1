"""Mean device ms an iteration of the update's all-reduce, learning rate,
gradient clip and Adam step (update.adam), from the stage stamps with the
profiler off (benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.ms_of(ctx, "update.adam")
