"""The physics kernel's (B1, or B1t on a heightfield) share of its
roofline, in %: the census bound of the iteration's launches over their
measured device time. Per launch the bound is the larger of the function's
float32 operations over 67 TFLOP/s and its rows over 3.35 TB/s, at the
launch's own env count: the envs of a policy step over the launches a step
(one launch per robot on the joint task)."""

from benchmark import census
from benchmark.devtrace import MEGA


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    count, secs = tr.matching(MEGA)
    cfg, T = ctx["config"], ctx["steps_per_env"]
    per_step, rest = divmod(count, T * tr.iters)
    envs = sum(ctx["envs_per_robot"])
    if rest or per_step == 0 or envs % per_step or secs <= 0:
        return None
    bound = T * per_step * census.physics_bound_s(envs // per_step, cfg["terrain"] != "flat",
                                                  cfg["decimation"], cfg["solver_iterations"])
    return bound / (secs / tr.iters) * 100.0
