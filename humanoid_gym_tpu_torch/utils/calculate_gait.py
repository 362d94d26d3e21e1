"""Offline swing-foot trajectory designer (reference
humanoid/utils/calculate_gait.py:36-124).

The PyTorch port's copy of humanoid_gym_tpu/utils/calculate_gait.py
(NumPy only).

Solves for the coefficients of a quintic polynomial z(t) describing swing-foot
height over one swing period, subject to the same boundary conditions the
reference uses: start/end heights and velocities, plus a peak height at
mid-swing. The reference solves a nonlinear system with fsolve; the system is
actually linear in the coefficients, so we solve it directly — same inputs,
same curve, no scipy dependency at import time.

Run as a script to print coefficients and optionally plot:
    python -m humanoid_gym_tpu_torch.utils.calculate_gait [--plot out.png]
"""

from __future__ import annotations

import numpy as np

# Reference boundary conditions (calculate_gait.py:104-117)
H0 = 0.0  # initial height [m]
H_SWING = 0.06  # peak swing height [m]  (matches rewards.target_feet_height)
V0 = 0.0  # initial vertical velocity
V_SWING = 0.0  # velocity at peak
T_SWING = 0.26  # swing duration [s]


def get_coefficients(
    h0: float = H0,
    h_peak: float = H_SWING,
    v0: float = V0,
    v_peak: float = V_SWING,
    T: float = T_SWING,
) -> np.ndarray:
    """Quintic z(t) = sum c_i t^i with:
    z(0)=h0, z'(0)=v0, z(T/2)=h_peak, z'(T/2)=v_peak, z(T)=h0, z'(T)=v0.
    Returns c (6,)."""
    tm = T / 2.0

    def row_pos(t):
        return [t**i for i in range(6)]

    def row_vel(t):
        return [0.0] + [i * t ** (i - 1) for i in range(1, 6)]

    A = np.array(
        [
            row_pos(0.0),
            row_vel(0.0),
            row_pos(tm),
            row_vel(tm),
            row_pos(T),
            row_vel(T),
        ]
    )
    b = np.array([h0, v0, h_peak, v_peak, h0, v0])
    return np.linalg.solve(A, b)


def evaluate(c: np.ndarray, t: np.ndarray) -> np.ndarray:
    return sum(ci * t**i for i, ci in enumerate(c))


def plot_curves(c: np.ndarray, out_path: str, T: float = T_SWING) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.linspace(0, T, 200)
    z = evaluate(c, t)
    dz = evaluate(np.arange(1, 6) * c[1:], t)  # derivative coefficients
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(8, 6))
    a1.plot(t, z)
    a1.set(xlabel="t [s]", ylabel="z [m]", title="Swing foot height")
    a2.plot(t, dz)
    a2.set(xlabel="t [s]", ylabel="dz/dt [m/s]", title="Vertical velocity")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--plot", type=str, default=None)
    args = p.parse_args()
    c = get_coefficients()
    print("quintic coefficients:", c)
    if args.plot:
        print("wrote", plot_curves(c, args.plot))
