"""The recurrent update's scans' share of their roofline, in %: the least
time of their work as the configuration's reference module counts it
(`bptt_least_s`: the gate matmuls at the bf16 peak plus the cells' float32
work at the float32 peak, or the bytes at the memory rate, whichever is
larger), over the stage's measured time (`stage_bptt_ms`): the same work
whatever computes it. None off the card, or where the reference module
counts no such work or the program stamps no such stage."""

from benchmark import stages
from benchmark.reference import module


def read(ctx):
    if ctx["device"] is None or ctx["device"].type != "cuda":
        return None
    least = getattr(module(ctx["config"]), "bptt_least_s", None)
    ms = stages.ms_of(ctx, "update.bptt")
    if least is None or not ms:
        return None
    cfg = dict(ctx["config"], steps_per_env=ctx["steps_per_env"])
    return least(cfg, sum(ctx["envs_per_robot"])) / (ms * 1e-3) * 100.0
