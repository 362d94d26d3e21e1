"""Interactive viewer with the PyTorch port (the counterpart of
scripts/view.py): drive a trained policy live in the browser.

Capability analog of the reference's PhysX viewer + keyboard loop
(humanoid/envs/base/base_task.py:104-110, play.py viewer path). The window
is a browser tab: an MJPEG stream and key events over HTTP
(humanoid_gym_tpu_torch/export/live_viewer.py). MuJoCo runs on the host's
CPU and the frames need `cv2`; the GPU machine has neither, so run it on
a CPU host.

Usage:
  python scripts/view_torch.py --policy <policy.npz|.pt>        # explicit file
  python scripts/view_torch.py --run_dir logs/XBot_ppo/<run>    # newest model_N.ckpt
  python scripts/view_torch.py --policy resources/policies/xbotl_robust_demo.npz \
      [--terrain] [--port 8800]

Then open http://127.0.0.1:8800 (forward the port if remote). Keys: arrows
vx/vy, q/e yaw, space stop, p push, r reset, v pause, ESC quit.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from humanoid_gym_tpu_torch import XBOT_MJCF as FLAT_MJCF  # noqa: E402
from humanoid_gym_tpu_torch import XBOT_TERRAIN_MJCF as TERRAIN_MJCF  # noqa: E402


def latest_checkpoint(run_dir: str):
    """(N, path) of the highest-numbered model_N.ckpt in run_dir."""
    ckpts = sorted(
        (int(re.search(r"model_(\d+)\.ckpt$", f).group(1)), f)
        for f in glob.glob(os.path.join(run_dir, "model_*.ckpt"))
    )
    if not ckpts:
        raise SystemExit(f"no model_*.ckpt in {run_dir}")
    return ckpts[-1]


def load_viewer_policy(policy: str | None, run_dir: str | None):
    """The policy to view: an artifact file, or the actor of the run's
    newest checkpoint (exported to a temporary directory)."""
    from humanoid_gym_tpu_torch.export import export_checkpoint, load_policy

    if policy:
        return load_policy(policy)
    n, path = latest_checkpoint(run_dir)
    with tempfile.TemporaryDirectory() as d:
        export_checkpoint(path, d)
        print(f"viewing checkpoint {n} of {run_dir}")
        return load_policy(os.path.join(d, "policy.npz"))


def main(argv=None):
    p = argparse.ArgumentParser()
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--policy", help="policy file (.npz or TorchScript .pt)")
    g.add_argument("--run_dir", help="training run dir (newest checkpoint)")
    p.add_argument("--terrain", action="store_true",
                   help="uneven.png deployment heightfield instead of flat")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--cmd_vx", type=float, default=0.0,
                   help="initial forward command (teleop from the browser)")
    args = p.parse_args(argv)

    from humanoid_gym_tpu_torch.export.live_viewer import LiveViewer
    from humanoid_gym_tpu_torch.export.sim2sim import Sim2SimCfg

    policy = load_viewer_policy(args.policy, args.run_dir)
    cfg = Sim2SimCfg(mujoco_model_path=TERRAIN_MJCF if args.terrain else FLAT_MJCF)
    viewer = LiveViewer(policy, cfg, fps=args.fps)
    viewer.cmd[0] = args.cmd_vx
    print(f"viewer at http://{args.host}:{args.port}  (ESC in the page quits)")
    viewer.serve(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
