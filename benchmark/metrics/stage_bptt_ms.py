"""Mean device ms an iteration of the recurrent policy's scans in the update
(update.bptt: both LSTMs' masked scan over the minibatch's rows, forward and
backward, in every minibatch), from the stage stamps with the profiler off
(benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.ms_of(ctx, "update.bptt")
