"""URDF parsing + fixed-joint collapse (host-side, NumPy, runs once at init).

Capability analog of Isaac Gym's asset pipeline used by the reference
(legged_robot.py:597-626: gym.load_asset with collapse_fixed_joints=True).
Builds the reduced articulated tree: every subtree connected by fixed joints
is merged into its movable ancestor with exact composite inertia
(rotation + parallel-axis composition).

Pure NumPy: the output feeds RobotModel construction. The PyTorch port's
copy of humanoid_gym_tpu/physics/urdf.py.
"""

from __future__ import annotations

import struct as _struct
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


# ----------------------------- small SO(3)/SE(3) helpers (numpy) -----------


def rpy_to_mat(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis rpy -> rotation matrix: R = Rz(y) @ Ry(p) @ Rx(r)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def mat_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w,x,y,z), numerically robust."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w, x, y, z = 0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s
    elif m00 > m11 and m00 > m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2
        w, x, y, z = (m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s
    elif m11 > m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2
        w, x, y, z = (m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2
        w, x, y, z = (m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


@dataclass
class Transform:
    R: np.ndarray  # (3,3)
    p: np.ndarray  # (3,)

    @staticmethod
    def identity() -> "Transform":
        return Transform(np.eye(3), np.zeros(3))

    @staticmethod
    def from_origin(el: Optional[ET.Element]) -> "Transform":
        if el is None:
            return Transform.identity()
        xyz = np.fromstring(el.get("xyz", "0 0 0"), sep=" ")
        rpy = np.fromstring(el.get("rpy", "0 0 0"), sep=" ")
        return Transform(rpy_to_mat(rpy), xyz)

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.R @ other.R, self.R @ other.p + self.p)

    def apply(self, v: np.ndarray) -> np.ndarray:
        return self.R @ v + self.p


# ----------------------------- URDF structures ------------------------------


@dataclass
class UrdfInertial:
    mass: float
    com: np.ndarray  # (3,) in link frame
    inertia: np.ndarray  # (3,3) about COM, in link frame axes (after rpy)


@dataclass
class UrdfCollision:
    kind: str  # 'box' | 'mesh' | 'sphere' | 'cylinder'
    origin: Transform
    size: Optional[np.ndarray] = None  # box full extents
    radius: Optional[float] = None
    length: Optional[float] = None
    mesh_file: Optional[str] = None
    mesh_scale: Optional[np.ndarray] = None  # (3,) URDF <mesh scale=...>


@dataclass
class UrdfLink:
    name: str
    inertial: Optional[UrdfInertial]
    collisions: List[UrdfCollision] = field(default_factory=list)


@dataclass
class UrdfJoint:
    name: str
    jtype: str
    parent: str
    child: str
    origin: Transform
    axis: np.ndarray
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0
    damping: float = 0.0
    friction: float = 0.0


def _parse_inertial(el: Optional[ET.Element]) -> Optional[UrdfInertial]:
    if el is None:
        return None
    origin = Transform.from_origin(el.find("origin"))
    mass = float(el.find("mass").get("value"))
    it = el.find("inertia")
    ixx, iyy, izz = (float(it.get(k)) for k in ("ixx", "iyy", "izz"))
    ixy, ixz, iyz = (float(it.get(k, "0")) for k in ("ixy", "ixz", "iyz"))
    I_local = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    # URDF: inertia expressed in the inertial-origin frame -> rotate to link axes
    I_link = origin.R @ I_local @ origin.R.T
    return UrdfInertial(mass=mass, com=origin.p.copy(), inertia=I_link)


def _parse_collision(el: ET.Element) -> Optional[UrdfCollision]:
    geo = el.find("geometry")
    if geo is None:
        return None
    origin = Transform.from_origin(el.find("origin"))
    box = geo.find("box")
    if box is not None:
        return UrdfCollision("box", origin, size=np.fromstring(box.get("size"), sep=" "))
    mesh = geo.find("mesh")
    if mesh is not None:
        scale = mesh.get("scale")
        return UrdfCollision(
            "mesh",
            origin,
            mesh_file=mesh.get("filename"),
            mesh_scale=np.fromstring(scale, sep=" ") if scale else None,
        )
    sph = geo.find("sphere")
    if sph is not None:
        return UrdfCollision("sphere", origin, radius=float(sph.get("radius")))
    cyl = geo.find("cylinder")
    if cyl is not None:
        return UrdfCollision(
            "cylinder", origin, radius=float(cyl.get("radius")), length=float(cyl.get("length"))
        )
    return None


@dataclass
class Urdf:
    links: Dict[str, UrdfLink]
    joints: List[UrdfJoint]
    root: str


def parse_urdf(path: str) -> Urdf:
    tree = ET.parse(path)
    robot = tree.getroot()
    links: Dict[str, UrdfLink] = {}
    for lel in robot.findall("link"):
        cols = [c for c in (_parse_collision(ce) for ce in lel.findall("collision")) if c]
        links[lel.get("name")] = UrdfLink(
            name=lel.get("name"),
            inertial=_parse_inertial(lel.find("inertial")),
            collisions=cols,
        )
    joints: List[UrdfJoint] = []
    for jel in robot.findall("joint"):
        axis_el = jel.find("axis")
        axis = (
            np.fromstring(axis_el.get("xyz"), sep=" ") if axis_el is not None else np.array([1.0, 0, 0])
        )
        lim = jel.find("limit")
        dyn = jel.find("dynamics")
        joints.append(
            UrdfJoint(
                name=jel.get("name"),
                jtype=jel.get("type"),
                parent=jel.find("parent").get("link"),
                child=jel.find("child").get("link"),
                origin=Transform.from_origin(jel.find("origin")),
                axis=axis / max(np.linalg.norm(axis), 1e-12),
                lower=float(lim.get("lower", "0")) if lim is not None else 0.0,
                upper=float(lim.get("upper", "0")) if lim is not None else 0.0,
                effort=float(lim.get("effort", "0")) if lim is not None else 0.0,
                velocity=float(lim.get("velocity", "0")) if lim is not None else 0.0,
                damping=float(dyn.get("damping", "0")) if dyn is not None else 0.0,
                friction=float(dyn.get("friction", "0")) if dyn is not None else 0.0,
            )
        )
    children = {j.child for j in joints}
    roots = [n for n in links if n not in children]
    assert len(roots) == 1, f"expected single root link, got {roots}"
    return Urdf(links=links, joints=joints, root=roots[0])


# ----------------------------- fixed-joint collapse -------------------------


@dataclass
class RigidBody:
    """A body of the reduced tree (after merging fixed subtrees)."""

    name: str
    parent: int  # index into the reduced body list; -1 for base
    joint: Optional[UrdfJoint]  # movable joint connecting to parent (None for base)
    # joint frame placement relative to the PARENT reduced body frame:
    joint_pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    joint_rot: np.ndarray = field(default_factory=lambda: np.eye(3))
    # composite inertia in THIS body frame (body frame == child link frame of joint):
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    # collision geoms accumulated into this body's frame: list of (Transform, UrdfCollision)
    collisions: List[Tuple[Transform, UrdfCollision]] = field(default_factory=list)
    # source link names merged into this body
    merged_links: List[str] = field(default_factory=list)


def _accumulate_inertia(body: RigidBody, X: Transform, inr: Optional[UrdfInertial]):
    """Add a link's inertia (at link pose X within body frame) to the composite."""
    if inr is None or inr.mass <= 0:
        return
    m_new = inr.mass
    com_new = X.apply(inr.com)
    I_new = X.R @ inr.inertia @ X.R.T  # still about its own COM
    m_tot = body.mass + m_new
    com_tot = (body.mass * body.com + m_new * com_new) / m_tot

    def _shift(I, m, c, c_tot):
        d = c - c_tot
        return I + m * ((d @ d) * np.eye(3) - np.outer(d, d))

    body.inertia = _shift(body.inertia, body.mass, body.com, com_tot) + _shift(
        I_new, m_new, com_new, com_tot
    )
    body.mass = m_tot
    body.com = com_tot


def collapse_fixed_joints(urdf: Urdf, dof_order: Optional[List[str]] = None) -> List[RigidBody]:
    """Build the reduced body tree.

    Bodies appear in DFS order following URDF joint declaration order (which for
    XBot-L reproduces the DOF ordering the reference assumes: left leg 6 joints
    then right leg 6, see config.xbotl.XBOT_DOF_NAMES).
    """
    by_parent: Dict[str, List[UrdfJoint]] = {}
    for j in urdf.joints:
        by_parent.setdefault(j.parent, []).append(j)

    bodies: List[RigidBody] = []

    def absorb(body: RigidBody, link_name: str, X: Transform):
        """Merge link (at pose X in body frame) and all its fixed descendants."""
        link = urdf.links[link_name]
        body.merged_links.append(link_name)
        _accumulate_inertia(body, X, link.inertial)
        for col in link.collisions:
            body.collisions.append((X * col.origin, col))
        for j in by_parent.get(link_name, []):
            if j.jtype == "fixed":
                absorb(body, j.child, X * j.origin)
            else:
                make_body(body_index_of[id(body)], j, X)

    pending: List[Tuple[int, UrdfJoint, Transform]] = []

    def make_body(parent_idx: int, joint: UrdfJoint, X_parent: Transform):
        pending.append((parent_idx, joint, X_parent))

    body_index_of: Dict[int, int] = {}

    base = RigidBody(name=urdf.root, parent=-1, joint=None)
    bodies.append(base)
    body_index_of[id(base)] = 0
    absorb(base, urdf.root, Transform.identity())

    # breadth-ish processing preserving declaration order
    while pending:
        parent_idx, joint, X_parent = pending.pop(0)
        X_joint = X_parent * joint.origin
        b = RigidBody(
            name=joint.child,
            parent=parent_idx,
            joint=joint,
            joint_pos=X_joint.p.copy(),
            joint_rot=X_joint.R.copy(),
        )
        bodies.append(b)
        body_index_of[id(b)] = len(bodies) - 1
        absorb(b, joint.child, Transform.identity())

    if dof_order is not None:
        jnames = [b.joint.name for b in bodies[1:]]
        assert set(jnames) == set(dof_order), (jnames, dof_order)
        order = [0] + [1 + jnames.index(n) for n in dof_order]
        remap = {old: new for new, old in enumerate(order)}
        bodies = [bodies[i] for i in order]
        for b in bodies:
            if b.parent >= 0:
                b.parent = remap[b.parent]
        # tree property: parent index < child index must hold after remap
        for i, b in enumerate(bodies):
            assert b.parent < i
    return bodies


# ----------------------------- STL sole extraction --------------------------


def read_stl_vertices(path: str) -> np.ndarray:
    """Read unique-ish vertices from a binary (or ascii) STL file."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            # try ascii; fall back to binary if parse fails
            try:
                txt = f.read().decode("ascii")
                vs = []
                for line in txt.splitlines():
                    line = line.strip()
                    if line.startswith("vertex"):
                        vs.append([float(x) for x in line.split()[1:4]])
                if vs:
                    return np.asarray(vs)
            except (UnicodeDecodeError, ValueError):
                f.seek(0)
        data = f.read()
    ntri = _struct.unpack("<I", data[80:84])[0]
    arr = np.frombuffer(data[84 : 84 + ntri * 50], dtype=np.uint8).reshape(ntri, 50)
    tri = arr[:, :48].copy().view(np.float32).reshape(ntri, 4, 3)
    return tri[:, 1:, :].reshape(-1, 3).astype(np.float64)


def foot_sole_points(
    mesh_path: str,
    down_local: np.ndarray,
    band: float = 0.004,
    n_points: int = 8,
) -> np.ndarray:
    """Pick contact candidate points on a foot mesh sole.

    Projects mesh vertices onto the local 'down' direction, keeps the extreme
    band (the sole plane), then returns the corners + edge midpoints of the
    bounding rectangle in the sole plane. Output: (n_points, 3) in link frame.
    """
    v = read_stl_vertices(mesh_path)
    d = down_local / np.linalg.norm(down_local)
    proj = v @ d
    sole = v[proj > proj.max() - band]
    # orthonormal basis of the sole plane
    a = np.array([1.0, 0.0, 0.0])
    if abs(a @ d) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    e1 = a - (a @ d) * d
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(d, e1)
    u, w = sole @ e1, sole @ e2
    h = proj.max()  # sole height along d
    corners_uw = [
        (u.min(), w.min()),
        (u.min(), w.max()),
        (u.max(), w.min()),
        (u.max(), w.max()),
        (u.min(), 0.5 * (w.min() + w.max())),
        (u.max(), 0.5 * (w.min() + w.max())),
        (0.5 * (u.min() + u.max()), w.min()),
        (0.5 * (u.min() + u.max()), w.max()),
    ][:n_points]
    pts = np.stack([uu * e1 + ww * e2 + h * d for uu, ww in corners_uw])
    return pts
