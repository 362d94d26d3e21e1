"""Mean device ms an iteration of the terrain patches (env.physics.terrain:
make_terrain_patches with make_contact_xy), summed over the robots, from the
stage stamps with the profiler off (benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.ms_of(ctx, "env.physics.terrain")
