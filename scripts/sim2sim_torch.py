"""MuJoCo sim2sim validation with the PyTorch port (the counterpart of
scripts/sim2sim.py, reference humanoid/scripts/sim2sim.py).

Usage:
    python scripts/sim2sim_torch.py --load_model <policy.npz|policy_jit.pt> \
        [--terrain] [--duration 60] [--video gait.mp4]

Replays an exported policy (`scripts/play_torch.py` writes it) in MuJoCo
with the deployment observation contract and prints the result. MuJoCo
runs on the host's CPU; the script needs `mujoco` (and `cv2` for
--video), which the GPU machine lacks, so run it on a CPU host.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from humanoid_gym_tpu_torch import XBOT_MJCF, XBOT_TERRAIN_MJCF  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser("sim2sim_torch")
    p.add_argument("--load_model", type=str, required=True)
    p.add_argument("--terrain", action="store_true")
    p.add_argument("--duration", type=float, default=60.0)
    p.add_argument(
        "--video", type=str, default=None,
        help="write a software-rendered mp4 of the rollout (reference "
        "play.py:127-134 capability; headless, no GL required)",
    )
    args = p.parse_args(argv)

    from humanoid_gym_tpu_torch.export import load_policy
    from humanoid_gym_tpu_torch.export.sim2sim import Sim2SimCfg, run_mujoco

    cfg = Sim2SimCfg(
        mujoco_model_path=XBOT_TERRAIN_MJCF if args.terrain else XBOT_MJCF,
        sim_duration=args.duration,
    )
    result = run_mujoco(load_policy(args.load_model), cfg, video_path=args.video)
    print(result)
    return result


if __name__ == "__main__":
    main()
