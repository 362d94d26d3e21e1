"""Per-rank env blocks, seeds, shared strings and checkpoint shards.

Port of humanoid_gym_tpu/parallel/multihost.py. Each rank builds and steps
only its own block of `num_envs / world` envs, so the env state never
exists whole in any one process. The JAX package's `assemble_global` and
`local_env_shard` have no counterpart: there a global array is assembled
from, and split back into, per-process shards; here a rank's tensors are
its shard, and nothing is assembled.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .mesh import EnvGroup


def local_env_slice(num_envs: int, group: Optional[EnvGroup]) -> Tuple[int, int]:
    """(start, count) of this rank's block of the global env axis; raises
    unless the world size divides `num_envs`."""
    if group is None:
        return 0, num_envs
    if num_envs % group.world != 0:
        raise ValueError(f"num_envs {num_envs} is not a multiple of the world size {group.world}")
    per = num_envs // group.world
    return group.rank * per, per


def rank_seed(seed: int, group: Optional[EnvGroup]) -> int:
    """The seed of this rank's own draws (env generators, action noise):
    `seed` itself at world size 1, else derived from (seed, rank) as
    `envs/joint.py` `sub_env_seed` derives a sub-env's. Draws that must agree
    on every rank (the minibatch permutation, the terrain map) take the
    shared seed instead."""
    if group is None or group.world == 1:
        return seed
    return int(np.random.SeedSequence([seed, group.rank]).generate_state(1)[0])


def shard_path(path: str, rank: int) -> str:
    """The file of rank `rank`'s env-state shard of checkpoint `path`."""
    return f"{path}.envshard{rank}"


def broadcast_str(s: Optional[str], group: Optional[EnvGroup], width: int = 1024) -> str:
    """Rank 0's string on every rank (a fixed-width uint8 broadcast), e.g.
    the timestamped run directory that each rank would otherwise name by
    its own clock."""
    if group is None or group.world == 1:
        return s or ""
    raw = (s or "").encode()[:width] if group.is_main else b""
    buf = torch.zeros((width,), dtype=torch.uint8)
    buf[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    buf = buf.to(group.device)
    torch.distributed.broadcast(buf, src=0)
    out = buf.cpu().numpy()
    return bytes(out[out != 0]).decode()
