"""humanoid_gym_tpu_torch: the PyTorch/CUDA port of humanoid_gym_tpu.

A second package beside the JAX one, which stays as the reference. The port
runs the main training path (flat-ground XBot-L PPO, `solver_type="mega"`)
on an NVIDIA H100:

- ``physics/`` : the batched rigid-body engine in PyTorch, plus the
  whole-policy-step physics kernel (``physics/mega.py``) and its contact
  solve (``physics/solve.py``) written in CUDA C++ for Hopper
  (``csrc/``). Every kernel has a plain PyTorch version beside it, which a
  CPU tensor takes; a CUDA tensor takes the kernel.
- ``envs/``    : the XBot-L environment as batched tensor code.
- ``algo/``    : the actor-critic nets and the PPO train iteration.

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
