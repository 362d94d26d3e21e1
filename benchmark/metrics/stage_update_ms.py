"""Mean device ms an iteration of the update's minibatch gather
(update.gather) and its loss forward and backward passes (update.grad), from
the stage stamps with the profiler off (benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.ms_of(ctx, "update.gather", "update.grad")
