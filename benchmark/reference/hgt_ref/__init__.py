"""A frozen copy of the plain path of `humanoid_gym_tpu_torch`: the
benchmark's reference for the training iteration it times.

The config, registry, env (flat, heightfield, joint XBot-L + XBot-S), the
batched rigid-body physics with the plain version of the whole-policy-step
physics (`physics/mega.py` `mega_step_plain`), the nets and the PPO
iteration, copied with their imports kept inside this package. Every kernel
wrapper is cut down to its plain version, so a CUDA tensor runs plain
PyTorch here too; nothing is loaded from `csrc/`. It imports nothing of the
port and nothing of JAX, and works the robot constants out again from the
repo's `resources/robots` files and the terrain map from the seed.
"""

import os

# the repo root: hgt_ref -> reference -> benchmark -> root
HGT_ROOT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
_XBOT_L_DIR = os.path.join(HGT_ROOT_DIR, "resources", "robots", "XBot-L")
XBOT_URDF = os.path.join(_XBOT_L_DIR, "urdf", "XBot-L.urdf")
# the MuJoCo deployment terrain (uneven.png), which the "deploy" terrain
# style samples
XBOT_TERRAIN_MJCF = os.path.join(_XBOT_L_DIR, "mjcf", "XBot-L-terrain.xml")
# the Froude-scaled XBot-S terrain model (scale 1.2 / 1.65; config/xbots.py)
_XBOT_S_DIR = os.path.join(HGT_ROOT_DIR, "resources", "robots", "XBot-S")
XBOT_S_TERRAIN_MJCF = os.path.join(_XBOT_S_DIR, "mjcf", "XBot-S-terrain.xml")
