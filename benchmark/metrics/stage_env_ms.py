"""Mean device ms an iteration of the env step's own work: the action
pipeline (env.actions), the base quantities, commands, push, kinematics and
termination (env.state), the curricula, auto-reset and episode bookkeeping
(env.reset) and, on a joint env, the join of the robots' transitions
(env.join), summed over the robots, from the stage stamps with the profiler
off (benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.ms_of(ctx, "env.actions", "env.state", "env.reset", "env.join")
