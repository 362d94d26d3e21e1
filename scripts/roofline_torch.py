"""FLOPs / bytes / issue census of one training iteration, and its shares of
the card's peaks (the counterpart of scripts/roofline.py).

The census lives in `humanoid_gym_tpu_torch/utils/roofline.py`, counted
from the port's own kernels and layouts: physics one mega launch an env a
policy step (`physics_flops_per_step`: the function's operations;
`physics_issue_per_step`: what the warps issue, every lane counted), the
rollout and learn matmuls of the nets, GAE, and the major device-memory
flows (`hbm_bytes`). The census is computed on the host and needs no card.

Usage:
    python scripts/roofline_torch.py [--envs 4096] [--terrain] [--iter-ms 780]
        [--device cuda|cpu]

With `--iter-ms` (a measured iteration time) it adds the shares of the
H100 SXM data sheet's peaks: every FLOP against 989 TFLOP/s bf16, the
physics against 67 TFLOP/s float32, the bytes against 3.35 TB/s. On
`--device cuda` (the default) it reads the card's name and power limit
with nvidia-smi, and raises without a card; `--device cpu` reads no card.
The last line is one JSON object of the census.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def census(envs: int, terrain: bool = False, T: int = 60) -> dict:
    """The census of one iteration at `envs` envs and horizon T."""
    from humanoid_gym_tpu_torch.utils.roofline import (
        hbm_bytes,
        net_flops,
        physics_flops_per_step,
        physics_issue_per_step,
    )

    phys = physics_flops_per_step(envs, terrain) * T
    roll_nn, learn_nn = net_flops(envs, T)
    gae = envs * T * 10  # reverse loop + normalization, ~10 FLOP a sample
    flows = hbm_bytes(envs, T, terrain)
    return {
        "envs": envs, "T": T, "terrain": terrain,
        "physics_flops": phys,
        "physics_issued_ops": physics_issue_per_step(envs, terrain) * T,
        "rollout_net_flops": roll_nn,
        "learn_net_flops": learn_nn,
        "gae_flops": gae,
        "total_flops": phys + roll_nn + learn_nn + gae,
        "bytes": flows,
        "total_bytes": sum(flows.values()),
    }


def shares(c: dict, iter_ms: float) -> dict:
    """The census at a measured iteration time against the data sheet's peaks."""
    from humanoid_gym_tpu_torch.utils.roofline import (
        PEAK_BF16_FLOPS,
        PEAK_BYTES_PER_S,
        PEAK_F32_FLOPS,
    )

    t = iter_ms / 1e3
    return {
        "iter_ms": iter_ms,
        "env_steps_per_s": c["envs"] * c["T"] / t,
        "flops_share_of_bf16_peak": c["total_flops"] / (t * PEAK_BF16_FLOPS),
        "physics_share_of_f32_peak": c["physics_flops"] / (t * PEAK_F32_FLOPS),
        "bytes_share_of_hbm_peak": c["total_bytes"] / (t * PEAK_BYTES_PER_S),
        "physics_issued_ops_per_s": c["physics_issued_ops"] / t,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--iter-ms", type=float, default=None,
                    help="measured training-iteration time (ms) for the shares of the peaks")
    ap.add_argument("--terrain", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    a = ap.parse_args(argv)

    from humanoid_gym_tpu_torch.utils.platform import card_line, resolve_device
    from humanoid_gym_tpu_torch.utils.roofline import (
        PEAK_BF16_FLOPS,
        PEAK_BYTES_PER_S,
        PEAK_F32_FLOPS,
    )

    device = resolve_device(a.device)
    c = census(a.envs, a.terrain)
    T = c["T"]
    print(f"== FLOPs per train iteration ({a.envs} envs, T={T}"
          f"{', heightfield' if a.terrain else ''}) ==")
    print(f"  physics kernel (f32)   {c['physics_flops'] / 1e9:10.2f} GFLOP")
    print(f"  rollout nets           {c['rollout_net_flops'] / 1e9:10.2f} GFLOP")
    print(f"  learn nets             {c['learn_net_flops'] / 1e9:10.2f} GFLOP")
    print(f"  GAE/misc               {c['gae_flops'] / 1e9:10.2f} GFLOP")
    print(f"  TOTAL                  {c['total_flops'] / 1e9:10.2f} GFLOP")
    print("== major device-memory flows ==")
    for k, v in c["bytes"].items():
        print(f"  {k:46s} {v / 1e6:9.1f} MB")
    print(f"  {'TOTAL':46s} {c['total_bytes'] / 1e9:9.2f} GB")
    print("== physics issue census ==")
    print(f"  issued f32 ops per iteration  {c['physics_issued_ops'] / 1e9:10.2f} G "
          f"(per env and substep: {c['physics_issued_ops'] / a.envs / T / 10:,.0f}; "
          f"the function needs {c['physics_flops'] / a.envs / T / 10:,.0f})")
    print(card_line(device) or "peaks: H100 SXM data sheet, no card read")
    if a.iter_ms:
        s = shares(c, a.iter_ms)
        c["shares"] = s
        print(f"== utilization at {a.iter_ms:.1f} ms/iter ({s['env_steps_per_s'] / 1e3:.0f}k env steps/s) ==")
        print(f"  FLOPs vs {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 peak      "
              f"{s['flops_share_of_bf16_peak'] * 100:8.4f} %")
        print(f"  physics vs {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32 peak       "
              f"{s['physics_share_of_f32_peak'] * 100:8.4f} %")
        print(f"  bytes vs {PEAK_BYTES_PER_S / 1e12:.2f} TB/s                  "
              f"{s['bytes_share_of_hbm_peak'] * 100:8.4f} %")
        print(f"  physics issue rate {s['physics_issued_ops_per_s'] / 1e12:.3f} T f32 ops/s "
              "(the kernel's run time tracks this axis: issue slots, not FLOPs)")
    print(json.dumps(c), flush=True)
    return c


if __name__ == "__main__":
    main()
