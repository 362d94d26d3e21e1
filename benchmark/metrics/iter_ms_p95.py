"""The 95th percentile of the runner's own dispatch-to-dispatch times
(Perf/iter_time) over the window's iterations, in ms."""

import statistics


def read(ctx):
    dt = ctx["iter_dt_s"]
    if len(dt) < 2:
        return None
    return statistics.quantiles(dt, n=20)[18] * 1e3
