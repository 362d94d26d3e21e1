"""Mean ms from the last stage stamp of one iteration to the first of the
next in the runner's own loop, stamps on the card's clock: the device work
between iterations (the permutation draw, the metric copies) and any time
the host holds the card idle (benchmark/stages.py)."""

import statistics

from benchmark import stages


def read(ctx):
    st = stages.measure(ctx)
    if st is None or not st["gaps"]:
        return None
    return statistics.mean(ms for ms, _ in st["gaps"])
