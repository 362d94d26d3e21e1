"""Generate the XBot-S MuJoCo validation models with the PyTorch port (the
counterpart of scripts/gen_xbots_mjcf.py).

Writes XBot-S.xml and XBot-S-terrain.xml from the port's Froude-scaled
XBot-S RobotModel (utils/scale_urdf.py + config/xbots.py) through the
port's `physics/mjcf_export.py`: floating base at standing height, per-DOF
torque motors at the scaled effort limits, the IMU 'orientation' /
'angular-velocity' sensors the deployment loop reads, plane (or the
Froude-scaled deployment heightfield) + 16 sole contact spheres, and the
controller kd baked into joint damping (implicit integration; explicit
-kd*dq at dt = 1 ms is unstable on the scaled, nearly massless ankle
bodies; same PD law).

Usage: python scripts/gen_xbots_mjcf_torch.py [--out_dir DIR]
The default DIR is resources/robots/XBot-S/mjcf, whose committed files a
run reproduces byte for byte.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from humanoid_gym_tpu_torch import HGT_ROOT_DIR  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", default=os.path.join(
        HGT_ROOT_DIR, "resources", "robots", "XBot-S", "mjcf"))
    args = p.parse_args(argv)

    from humanoid_gym_tpu_torch.config.xbots import SCALE, XBotSCfg
    from humanoid_gym_tpu_torch.physics.mjcf_export import model_to_mjcf
    from humanoid_gym_tpu_torch.physics.model import build_model_from_urdf

    cfg = XBotSCfg()
    m = build_model_from_urdf(
        cfg.asset.file,
        dof_order=list(cfg.init_state.default_joint_angles.keys()),
        foot_name=cfg.asset.foot_name,
        knee_name=cfg.asset.knee_name,
        termination_names=tuple(cfg.asset.terminate_after_contacts_on),
        penalized_names=tuple(cfg.asset.penalize_contacts_on),
        armature=cfg.asset.armature,
        mesh_dir=cfg.asset.mesh_dir,
    )
    kd = np.array([10.0] * 12) * SCALE**4.5  # config/xbots.py damping
    common = dict(
        armature=cfg.asset.armature,
        with_contacts=True,
        friction=0.9,  # reference XBot-L.xml geom friction
        joint_damping=m.dof_damping.double().numpy() + kd,
        deployable=True,
        base_z=float(cfg.init_state.pos[2]),
    )
    # the deployment-terrain variant: the same uneven.png as the XBot-L
    # hfield (reference XBot-L-terrain.xml:151 size="50 50 0.35 0.1") with
    # every extent Froude-scaled by s, so XBot-S faces the same relative
    # footing difficulty
    models = {
        "XBot-S.xml": model_to_mjcf(m, **common),
        "XBot-S-terrain.xml": model_to_mjcf(
            m, **common, hfield_png="../../XBot-L/terrain/uneven.png",
            hfield_size=(50 * SCALE, 50 * SCALE, 0.35 * SCALE, 0.1 * SCALE)),
    }
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for name, xml in models.items():
        out = os.path.join(args.out_dir, name)
        with open(out, "w") as f:
            f.write(xml)
        print(f"wrote {out} ({len(xml)} bytes)")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
