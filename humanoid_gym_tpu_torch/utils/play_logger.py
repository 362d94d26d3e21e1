"""Play-time state dashboard (reference humanoid/utils/logger.py:37-137).

Renders the same 3x3 panel set (joint target vs measured, dof velocity,
base velocity xyz/yaw vs command, contact forces, torque, torque-velocity
curve) to a PNG instead of spawning an interactive matplotlib process.
The PyTorch port's copy of humanoid_gym_tpu/utils/play_logger.py: the
traces are NumPy arrays, as `scripts/play_torch.py` writes them.
"""

from __future__ import annotations

import numpy as np


def plot_states(traces: dict, dt: float, out_path: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(traces["dof_pos"])
    t = np.arange(n) * dt
    fig, axs = plt.subplots(3, 3, figsize=(16, 10))

    a = axs[0, 0]
    a.plot(t, traces["dof_pos"], label="measured")
    a.plot(t, traces["dof_pos_target"], label="target")
    a.set(xlabel="time [s]", ylabel="pos [rad]", title="DOF position")
    a.legend()

    a = axs[0, 1]
    a.plot(t, traces["dof_vel"], label="measured")
    a.set(xlabel="time [s]", ylabel="vel [rad/s]", title="DOF velocity")
    a.legend()

    a = axs[0, 2]
    a.plot(t, traces["base_vel_x"], label="measured")
    a.plot(t, traces["command_x"], label="commanded")
    a.set(xlabel="time [s]", ylabel="vel [m/s]", title="Base vel x")
    a.legend()

    a = axs[1, 0]
    a.plot(t, traces["base_vel_y"], label="measured")
    a.plot(t, traces["command_y"], label="commanded")
    a.set(xlabel="time [s]", ylabel="vel [m/s]", title="Base vel y")
    a.legend()

    a = axs[1, 1]
    a.plot(t, traces["base_vel_yaw"], label="measured")
    a.plot(t, traces["command_yaw"], label="commanded")
    a.set(xlabel="time [s]", ylabel="vel [rad/s]", title="Base vel yaw")
    a.legend()

    a = axs[1, 2]
    a.plot(t, traces["base_vel_z"], label="measured")
    a.set(xlabel="time [s]", ylabel="vel [m/s]", title="Base vel z")
    a.legend()

    a = axs[2, 0]
    forces = np.asarray(traces["contact_forces_z"])
    for i in range(forces.shape[1]):
        a.plot(t, forces[:, i], label=f"force {i}")
    a.set(xlabel="time [s]", ylabel="force [N]", title="Vertical contact forces")
    a.legend()

    a = axs[2, 1]
    a.plot(traces["dof_vel"], traces["dof_torque"], "x")
    a.set(xlabel="vel [rad/s]", ylabel="torque [Nm]", title="Torque/velocity")

    a = axs[2, 2]
    a.plot(t, traces["dof_torque"], label="torque")
    a.set(xlabel="time [s]", ylabel="torque [Nm]", title="Torque")
    a.legend()

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def print_rewards(traces: dict, dt: float) -> None:
    """Aggregate episode reward report (reference logger.py:129-135)."""
    rew = np.asarray(traces["reward"])
    print(f"Average reward/step: {rew.mean():.4f}")
    print(f"Total steps: {len(rew)}  ({len(rew) * dt:.1f} s)")
