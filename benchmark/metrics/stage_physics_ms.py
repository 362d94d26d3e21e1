"""Mean device ms an iteration of the env's physics stage without its
terrain patches (env.physics - env.physics.terrain: the targets, the packing,
the mega kernel and the unpacking), summed over the robots, from the stage
stamps with the profiler off (benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    physics = stages.ms_of(ctx, "env.physics")
    return None if physics is None else physics - (stages.ms_of(ctx, "env.physics.terrain") or 0.0)
