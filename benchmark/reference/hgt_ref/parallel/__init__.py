"""Env-data-parallel training over several processes with torch.distributed.

The port's counterpart of humanoid_gym_tpu/parallel/ (SURVEY.md §2.3): the
env axis is sharded over the ranks, one process per rank, each stepping
`num_envs / world` envs on its own device with the same kernels; parameters
and Adam state are replicated. The only cross-rank traffic is where the JAX
program's global mean or sum over the sharded env axis becomes a psum: the
gradients, the advantage statistics, the minibatch KL mean, the logged
metrics and the command curriculum's mean. At world size 1 no collective
runs.
"""

from .mesh import EnvGroup, all_reduce_sum, make_env_group, replicate
from .multihost import broadcast_str, local_env_slice, rank_seed, shard_path, stream_seed

__all__ = [
    "EnvGroup", "all_reduce_sum", "broadcast_str", "local_env_slice", "make_env_group",
    "rank_seed", "replicate", "shard_path", "stream_seed",
]
