"""Geometric robot scaling: derive XBot-S-class models from the XBot-L URDF.

The PyTorch port's copy of humanoid_gym_tpu/utils/scale_urdf.py. A scale s
applies to a URDF as:

  lengths            x s        (joint/visual/collision origins, geometry)
  masses             x s^3      (constant density)
  inertias           x s^5      (mass x length^2)
  joint effort       x s^4      (gravity torque ~ m g L ~ s^4)
  joint velocity     x 1/sqrt(s) (Froude-consistent angular rate)
  damping            x s^4.5    (effort per angular rate)

Froude scaling preserves gait dynamics: time scales as sqrt(s), so config
quantities like cycle_time scale by sqrt(s) and PD gains by s^4 (kp) /
s^4.5 (kd) (config/xbots.py).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np


def _scale_vec_attr(el, attr: str, s: float):
    v = el.get(attr)
    if v is None:
        return
    vals = np.array(v.split(), dtype=np.float64) * s
    el.set(attr, " ".join(f"{x:.9g}" for x in vals))


def scale_urdf(src_path: str, dst_path: str, s: float, name_suffix: str = "") -> str:
    """Write the URDF at `src_path` scaled by `s` to `dst_path`."""
    tree = ET.parse(src_path)
    root = tree.getroot()
    if name_suffix:
        root.set("name", root.get("name", "robot") + name_suffix)

    for origin in root.iter("origin"):
        _scale_vec_attr(origin, "xyz", s)
    for inertial in root.iter("inertial"):
        mass = inertial.find("mass")
        if mass is not None:
            mass.set("value", f"{float(mass.get('value')) * s**3:.9g}")
        inertia = inertial.find("inertia")
        if inertia is not None:
            for a in ("ixx", "ixy", "ixz", "iyy", "iyz", "izz"):
                if inertia.get(a) is not None:
                    inertia.set(a, f"{float(inertia.get(a)) * s**5:.9g}")
    for mesh in root.iter("mesh"):
        base = np.array(mesh.get("scale", "1 1 1").split(), dtype=np.float64)
        mesh.set("scale", " ".join(f"{x:.9g}" for x in base * s))
    for box in root.iter("box"):
        _scale_vec_attr(box, "size", s)
    for sph in root.iter("sphere"):
        sph.set("radius", f"{float(sph.get('radius')) * s:.9g}")
    for cyl in root.iter("cylinder"):
        cyl.set("radius", f"{float(cyl.get('radius')) * s:.9g}")
        cyl.set("length", f"{float(cyl.get('length')) * s:.9g}")
    for limit in root.iter("limit"):
        if limit.get("effort") is not None:
            limit.set("effort", f"{float(limit.get('effort')) * s**4:.9g}")
        if limit.get("velocity") is not None:
            limit.set("velocity", f"{float(limit.get('velocity')) / np.sqrt(s):.9g}")
    for dyn in root.iter("dynamics"):
        if dyn.get("damping") is not None:
            dyn.set("damping", f"{float(dyn.get('damping')) * s**4.5:.9g}")

    os.makedirs(os.path.dirname(dst_path), exist_ok=True)
    tree.write(dst_path)
    return dst_path


def ensure_xbot_s(repo_root: str | None = None, s: float = 1.2 / 1.65) -> str:
    """The XBot-S URDF path, generated from XBot-L's only if the file is
    missing (the repo ships it, and it is not rewritten)."""
    from .. import HGT_ROOT_DIR, XBOT_URDF

    dst = os.path.join(repo_root or HGT_ROOT_DIR, "resources", "robots", "XBot-S", "urdf",
                       "XBot-S.urdf")
    if not os.path.exists(dst):
        scale_urdf(XBOT_URDF, dst, s, name_suffix="-S")
    return dst
