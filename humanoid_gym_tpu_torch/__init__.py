"""humanoid_gym_tpu_torch: the PyTorch/CUDA port of humanoid_gym_tpu.

A second package beside the JAX one, which stays as the reference. The port
runs PPO training of XBot-L, of its Froude-scaled XBot-S, and of both in one
batch under one policy, on flat ground and on heightfield terrain (the
terrain tasks, the deployment heightfield and the terrain curriculum), on
an NVIDIA H100 with any of the JAX package's solvers: `solver_type="mega"`
(one kernel launch per policy step, the default on the card) or the
per-substep path (`apgd`, `pgs`, `apgd_pallas`, `fused_pallas`).

- ``physics/`` : the batched rigid-body engine in PyTorch, plus the kernels
  written in CUDA C++ for Hopper (``csrc/``): the whole-policy-step physics
  kernel (``physics/mega.py``) with its contact solve, and the two dense
  contact-solve kernels of the substep path (``physics/solve.py``). Every
  kernel has a plain PyTorch version beside it, which a CPU tensor takes;
  a CUDA tensor takes the kernel.
- ``envs/``    : the XBot environment as batched tensor code, and the
  joint XBot-L + XBot-S batch (``envs/joint.py``).
- ``terrain/`` : the terrain map (NumPy, once at init) and its height
  lookups as torch functions.
- ``algo/``    : the actor-critic nets (with the optional estimator head)
  and the PPO train iteration.
- ``export/``  : the deployment artifacts of a trained actor (``policy.npz``,
  ``policy.bin``, ``policy_jit.pt``) and their loader.
- ``runner/``  : the training loop with logging and checkpoints.
- ``registry`` and ``utils/``: the task registry, the command line of
  ``scripts/train_torch.py`` and the URDF scaling that derives XBot-S.

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
XBOT_MJCF = os.environ.get(
    "HGT_XBOT_MJCF", os.path.join(_XBOT_L_DIR, "mjcf", "XBot-L.xml")
)
# the MuJoCo deployment terrain (uneven.png), which the "deploy" terrain
# style samples
XBOT_TERRAIN_MJCF = os.environ.get(
    "HGT_XBOT_TERRAIN_MJCF",
    os.path.join(_XBOT_L_DIR, "mjcf", "XBot-L-terrain.xml"),
)
# the Froude-scaled XBot-S models (scale 1.2 / 1.65; config/xbots.py)
_XBOT_S_DIR = os.path.join(HGT_ROOT_DIR, "resources", "robots", "XBot-S")
XBOT_S_MJCF = os.environ.get(
    "HGT_XBOT_S_MJCF", os.path.join(_XBOT_S_DIR, "mjcf", "XBot-S.xml")
)
XBOT_S_TERRAIN_MJCF = os.environ.get(
    "HGT_XBOT_S_TERRAIN_MJCF", os.path.join(_XBOT_S_DIR, "mjcf", "XBot-S-terrain.xml")
)

__version__ = "0.1.0"
