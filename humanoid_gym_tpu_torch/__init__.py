"""humanoid_gym_tpu_torch: the PyTorch/CUDA port of humanoid_gym_tpu.

A second package beside the JAX one, which stays as the reference. The port
runs XBot-L PPO training on flat ground and on heightfield terrain (the
terrain tasks and their curriculum) on an NVIDIA H100 with any of the JAX
package's solvers: `solver_type="mega"` (one kernel launch per policy step,
the default on the card) or the per-substep path (`apgd`, `pgs`,
`apgd_pallas`, `fused_pallas`).

- ``physics/`` : the batched rigid-body engine in PyTorch, plus the kernels
  written in CUDA C++ for Hopper (``csrc/``): the whole-policy-step physics
  kernel (``physics/mega.py``) with its contact solve, and the two dense
  contact-solve kernels of the substep path (``physics/solve.py``). Every
  kernel has a plain PyTorch version beside it, which a CPU tensor takes;
  a CUDA tensor takes the kernel.
- ``envs/``    : the XBot-L environment as batched tensor code.
- ``terrain/`` : the terrain map (NumPy, once at init) and its height
  lookups as torch functions.
- ``algo/``    : the actor-critic nets and the PPO train iteration.
- ``runner/``  : the training loop with logging and checkpoints.
- ``registry`` and ``utils/``: the task registry and the command line of
  ``scripts/train_torch.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The robot assets are the repo's ``resources/`` tree, shared with the JAX
package.
"""

import os

HGT_ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_XBOT_L_DIR = os.path.join(HGT_ROOT_DIR, "resources", "robots", "XBot-L")
XBOT_URDF = os.environ.get(
    "HGT_XBOT_URDF", os.path.join(_XBOT_L_DIR, "urdf", "XBot-L.urdf")
)

__version__ = "0.1.0"
