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
    """The seed of this rank's env generators: `seed` itself at world size
    1, else derived from (seed, rank) as `envs/joint.py` `sub_env_seed`
    derives a sub-env's. Draws that must agree on every rank (the
    minibatch permutation, the terrain map) take the shared seed instead;
    the runner's own streams take `stream_seed`."""
    if group is None or group.world == 1:
        return seed
    return int(np.random.SeedSequence([seed, group.rank]).generate_state(1)[0])


# The runner's own random streams, each apart from the env's and from every
# other: the tag of each in `stream_seed`'s spawn key.
STREAMS = {"action_noise": 1, "episode_length": 2, "net_init": 3}


def stream_seed(seed: int, stream: str, group: Optional[EnvGroup] = None) -> int:
    """The seed of stream `stream` (a key of STREAMS) of a run seeded
    `seed`, on this rank (rank 0 without a group; a stream that must agree
    on every rank passes no group), as the JAX runner splits one key into
    independent streams. Layout: `SeedSequence(seed, spawn_key=(tag,
    rank))`. Its entropy is seed, three zero words (the 4-word pool's
    padding), tag and rank: six words, where `rank_seed`, `sub_env_seed`
    and `algo/ppo.py` `permutation_seed` hash at most four, and a zero word
    inside the pool adds nothing (`SeedSequence([5, 0])` equals
    `SeedSequence(5)`), so no tag or rank makes one of their states."""
    rank = 0 if group is None else group.rank
    return int(np.random.SeedSequence(seed, spawn_key=(STREAMS[stream], rank))
               .generate_state(1)[0])


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
