"""Env steps per second over the window: T x envs x the iterations whose
metrics the runner fetched in the window, over the window's seconds (first
timed dispatch to the last fetch); the runner's Perf/total_fps taken over
the whole window."""


def read(ctx):
    return ctx["env_steps_per_iter"] * ctx["window_iters"] / ctx["window_s"]
