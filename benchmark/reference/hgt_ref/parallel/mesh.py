"""The process group of an env-sharded run, and its two collectives.

Port of humanoid_gym_tpu/parallel/mesh.py. Where the JAX package lays a
one-axis device mesh over every chip and lets XLA insert the psums, the
port runs one process per rank (launched by `torchrun`, or any spawner that
sets RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT) and calls
the collectives itself:

    group = make_env_group("nccl")       # or "gloo": CPU ranks, or ranks sharing one card
    replicate(list(net.parameters()), group)      # rank 0's values everywhere
    grads = all_reduce_sum(grads, group)          # one collective for the list

`all_reduce_sum` packs its tensors into one float32 buffer and runs a single
all-reduce (`all_reduce_flat`), so a PPO minibatch costs one collective: the
gradients, the KL sum, the metric sums and the row count travel together.
It is the one place where a collective of the training iteration runs, so
it is where a captured iteration is cut: while `EnvGroup.on_collective` is
set (`algo/capture.py` `CutGraphs`, recording), the packed buffer goes to it
in place of the all-reduce. Backends: `nccl`
when every rank has a card of its own; `gloo` for CPU ranks and for several
ranks on one card (NCCL puts no two ranks on one device). The installed
`gloo` takes CUDA tensors for `all_reduce` and `broadcast` (checked on the
H100 machine with torch 2.11), so no buffer is staged through host memory
here; gloo copies through the host itself.

With no group (`None`), or at world size 1, every function here returns at
once and no collective runs.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, List, Optional, Sequence

import torch

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class EnvGroup:
    """One rank's view of the run: its rank, the world size, the device its
    envs live on and the backend of the process group. `collectives` and
    `reduced_bytes` count the all-reduces and their payload since the
    group was made. `on_collective(flat, group)`, where set, takes the
    packed buffer of each `all_reduce_sum` in place of its all-reduce."""

    rank: int
    world: int
    device: torch.device
    backend: str
    collectives: int = 0
    reduced_bytes: int = 0
    on_collective: Optional[Callable] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if self.world > 1:
            torch.distributed.barrier()

    def close(self) -> None:
        """Destroy the process group (the end of the rank's run)."""
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def make_env_group(backend: str, device=None, init_method: Optional[str] = None,
                   rank: Optional[int] = None, world: Optional[int] = None) -> EnvGroup:
    """Join the process group the launcher set up: rank RANK of WORLD_SIZE
    (or `rank` of `world`, for a group the caller sets up itself, such as
    one process at world size 1), meeting through `init_method` ("env://",
    i.e. MASTER_ADDR / MASTER_PORT, unless given). The device is
    `cuda:LOCAL_RANK` unless `device` names one ("cpu" for CPU ranks,
    "cuda:0" for ranks that share a card). A rank that waits on a
    collective for 10 minutes raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    if device is None or str(device) == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.distributed.init_process_group(
        backend, init_method=init_method or "env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(minutes=10),
    )
    return EnvGroup(rank=rank, world=world, device=device, backend=backend)


def _single(group: Optional[EnvGroup]) -> bool:
    return group is None or group.world == 1


def all_reduce_sum(tensors: Sequence[torch.Tensor], group: Optional[EnvGroup]
                   ) -> List[torch.Tensor]:
    """The elementwise sums over the ranks of `tensors` (any shapes and
    dtypes, all on the group's device), by one all-reduce of one float32
    buffer; returned in the tensors' own shapes and dtypes. Integer counts
    stay exact below 2**24. Every rank gets the same bits."""
    if _single(group):
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    if group.on_collective is None:
        all_reduce_flat(flat, group)
    else:
        group.on_collective(flat, group)
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    return out


def all_reduce_flat(flat: torch.Tensor, group: EnvGroup) -> None:
    """All-reduce (sum) the float32 buffer `flat` in place over the group,
    counted in `collectives` and `reduced_bytes`."""
    torch.distributed.all_reduce(flat)
    group.collectives += 1
    group.reduced_bytes += flat.numel() * 4


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], group: Optional[EnvGroup]) -> None:
    """Overwrite `tensors` in place with rank 0's values (one broadcast of
    one packed buffer): the counterpart of the JAX package's `replicate`."""
    if _single(group):
        return
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    torch.distributed.broadcast(flat, src=0)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].reshape(t.shape))
        off += n
