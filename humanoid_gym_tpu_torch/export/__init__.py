"""Deployment: the artifacts of a trained actor (`policy.npz`, `policy.bin`
and `policy_jit.pt` in the JAX package's formats) and their loader, and the
tools that carry a policy to MuJoCo on the host's CPU: the sim2sim loop
(`sim2sim.py`), the gait video (`video.py`), the native eval farm's front
end (`native_eval.py`) and the live viewer (`live_viewer.py`). The tools
import `mujoco` / `cv2` only when called."""

from .policy_export import NumpyPolicy, export_checkpoint, export_policy, load_policy

__all__ = ["NumpyPolicy", "export_checkpoint", "export_policy", "load_policy"]
