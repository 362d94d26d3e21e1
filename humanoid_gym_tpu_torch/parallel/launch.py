"""Start one process per rank with the variables `torchrun` sets.

    job = RankJob([sys.executable, "worker.py"], world=2)
    outputs = job.wait(timeout_s=600)      # raises if a rank fails

Each rank gets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR
and MASTER_PORT (a free port on localhost), so `make_env_group` finds what
it would find under `torchrun --standalone --nproc_per_node=<world>`. A
rank's output (stdout and stderr) goes to a file, so no pipe fills while
another rank is waited on. If one rank fails or the time runs out, every
rank still running is killed: no process outlives the job.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankJob:
    def __init__(self, argv: Sequence[str], world: int, env: Optional[dict] = None):
        base = dict(os.environ if env is None else env)
        base.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                    MASTER_PORT=str(free_port()))
        self._dir = tempfile.TemporaryDirectory(prefix="hgt_ranks_")
        self.logs = [os.path.join(self._dir.name, f"rank{r}.log") for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as out:
                self.procs.append(subprocess.Popen(
                    list(argv), env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=out, stderr=subprocess.STDOUT))

    def _outputs(self) -> List[str]:
        outs = []
        for path in self.logs:
            with open(path, errors="replace") as f:
                outs.append(f.read())
        return outs

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self, timeout_s: float) -> List[str]:
        """Each rank's output once every rank exited 0; else kill the rest
        and raise RuntimeError with the failing rank's output."""
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad or all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks still running after {timeout_s} s:\n"
                                       + self._outputs()[0][-4000:])
                time.sleep(0.1)
        finally:
            self.kill()
        outs = self._outputs()
        self._dir.cleanup()
        if bad:
            r = bad[0]
            raise RuntimeError(f"rank {r} of {len(self.procs)} exited {codes[r]}:\n{outs[r][-6000:]}")
        return outs
