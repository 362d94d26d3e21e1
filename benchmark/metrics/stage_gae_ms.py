"""Mean device ms an iteration of the last value, GAE and the advantage
normalisation (gae), from the stage stamps with the profiler off
(benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.ms_of(ctx, "gae")
