"""Host seconds of registry.make_env: the robot models, the terrain map and
the env (registry, envs/, terrain/)."""


def read(ctx):
    return ctx["setup_env_s"]
