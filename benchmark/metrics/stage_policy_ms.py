"""Mean device ms an iteration of the rollout's policy work (rollout.policy:
act, evaluate, the noise draw and the log-probability) and buffer writes
(rollout.store), from the stage stamps with the profiler off
(benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.ms_of(ctx, "rollout.policy", "rollout.store")
