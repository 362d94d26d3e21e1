"""Headless gait video: software-rendered mp4 of a MuJoCo rollout.

Capability analog of the reference's camera-to-mp4 recording
(humanoid/scripts/play.py:90-113,127-134, which needs the Isaac Gym viewer
and OpenCV). It needs no OpenGL platform (no EGL/OSMesa/X11), which a
headless host lacks, so `mujoco.Renderer` is not used; instead we
rasterize the robot ourselves with OpenCV draw calls from MuJoCo's
forward-kinematics outputs:

- every geom is projected into a side view (world x-z) and a front-view
  inset (world y-z), camera following the base;
- spheres/capsules/cylinders draw as discs / thick segments, boxes and mesh
  AABBs as filled convex polygons, painter-sorted by depth;
- a world-fixed ground grid gives motion parallax, plus a HUD with time,
  base velocity and height.

The result is a genuine visual of the gait (foot clearance, stride, lean)
encodable with the mp4v codec.

The PyTorch port's copy of humanoid_gym_tpu/export/video.py (NumPy,
OpenCV and MuJoCo only): the same frames for the same `MjData`.
"""

from __future__ import annotations

import numpy as np

# mjGEOM enum values (mujoco/mjmodel.h) — constants to avoid importing
# mujoco at module import time
_PLANE, _HFIELD, _SPHERE, _CAPSULE, _ELLIPSOID, _CYLINDER, _BOX, _MESH = range(8)

_TORSO = (150, 150, 150)
_LEFT = (190, 120, 40)  # BGR: blue-ish
_RIGHT = (60, 70, 200)  # BGR: red-ish


def _body_colors(m):
    """Color per body: left leg blue, right leg red, torso/arms gray."""
    import mujoco

    colors = []
    for b in range(m.nbody):
        name = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_BODY, b) or ""
        n = name.lower()
        if "left" in n or n.startswith("l_"):
            colors.append(_LEFT)
        elif "right" in n or n.startswith("r_"):
            colors.append(_RIGHT)
        else:
            colors.append(_TORSO)
    return colors


class GaitVideoRenderer:
    """Accumulates frames from `mujoco.MjData` snapshots; writes mp4."""

    def __init__(
        self,
        mj_model,
        width: int = 960,
        height: int = 540,
        fps: int = 50,
        scale: float = 220.0,  # pixels per meter
        follow_body: int = 1,  # body index the camera tracks (base)
    ):
        self.m = mj_model
        self.w, self.h = width, height
        self.fps = fps
        self.scale = scale
        self.follow = follow_body
        self.frames: list[np.ndarray] = []
        self._colors = _body_colors(mj_model)
        # precompute unit box corners
        self._corners = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float64,
        )

    # ---- projections ---------------------------------------------------- #

    def _side(self, pts, cam_x):
        """world (x, z) -> main panel pixels."""
        u = (pts[:, 0] - cam_x) * self.scale + 0.42 * self.w
        v = 0.92 * self.h - pts[:, 2] * self.scale
        return np.stack([u, v], axis=1)

    def _front(self, pts, cam_y):
        """world (y, z) -> inset pixels (top-right)."""
        s = self.scale * 0.45
        u = (pts[:, 1] - cam_y) * s + 0.86 * self.w
        v = 0.40 * self.h - pts[:, 2] * s
        return np.stack([u, v], axis=1)

    # ---- frame ----------------------------------------------------------- #

    def add_frame(self, data, hud: str = ""):
        import cv2

        m = self.m
        img = np.full((self.h, self.w, 3), 245, np.uint8)
        cam = data.xpos[self.follow].copy()

        # ground grid (world-fixed 0.5 m ticks -> motion parallax)
        gy = int(0.92 * self.h)
        cv2.line(img, (0, gy), (self.w, gy), (150, 150, 150), 2)
        x0 = cam[0] - 0.42 * self.w / self.scale
        first = np.ceil(x0 / 0.5) * 0.5
        for i in range(int(self.w / self.scale / 0.5) + 2):
            gx = first + 0.5 * i
            u = int((gx - cam[0]) * self.scale + 0.42 * self.w)
            major = abs(gx - round(gx)) < 1e-6
            cv2.line(img, (u, gy), (u, gy + (12 if major else 6)),
                     (120, 120, 120), 2 if major else 1)
            if major:
                cv2.putText(img, f"{gx:.0f}m", (u - 14, gy + 28),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.45, (90, 90, 90), 1)
        # inset ground
        iy = int(0.40 * self.h)
        cv2.line(img, (int(0.72 * self.w), iy), (self.w, iy), (180, 180, 180), 1)

        # collect geom draw ops, painter-sorted far-to-near (y descending
        # for the side view: camera looks along -y)
        order = np.argsort(-data.geom_xpos[:, 1])
        for g in order:
            gtype = m.geom_type[g]
            if gtype in (_PLANE, _HFIELD):
                continue
            color = self._colors[m.geom_bodyid[g]]
            pos = data.geom_xpos[g]
            R = data.geom_xmat[g].reshape(3, 3)
            size = m.geom_size[g]
            if gtype == _SPHERE:
                self._disc(img, pos, size[0], color, cam)
            elif gtype in (_CAPSULE, _CYLINDER):
                half = R[:, 2] * size[1]
                self._segment(img, pos - half, pos + half, size[0], color, cam)
            elif gtype == _ELLIPSOID:
                self._disc(img, pos, float(size.max()), color, cam)
            else:  # BOX or MESH (AABB in geom frame)
                if gtype == _MESH:
                    aabb = m.geom_aabb[g]
                    centers = pos + R @ aabb[:3]
                    half = aabb[3:]
                else:
                    centers, half = pos, size
                corners = centers + (self._corners * half) @ R.T
                self._hull(img, corners, color, cam)

        if hud:
            cv2.putText(img, hud, (16, 30), cv2.FONT_HERSHEY_SIMPLEX,
                        0.6, (60, 60, 60), 1, cv2.LINE_AA)
        self.frames.append(img)

    # ---- primitive rasterizers ------------------------------------------ #

    def _both_views(self, pts, cam):
        return self._side(pts, cam[0]), self._front(pts, cam[1])

    def _disc(self, img, pos, r, color, cam):
        import cv2

        pts = np.asarray(pos, np.float64)[None]
        for proj, s in ((self._side(pts, cam[0]), self.scale),
                        (self._front(pts, cam[1]), self.scale * 0.45)):
            c = tuple(int(v) for v in proj[0])
            cv2.circle(img, c, max(int(r * s), 2), color, -1, cv2.LINE_AA)

    def _segment(self, img, p0, p1, r, color, cam):
        import cv2

        pts = np.stack([p0, p1])
        for proj, s in ((self._side(pts, cam[0]), self.scale),
                        (self._front(pts, cam[1]), self.scale * 0.45)):
            a = tuple(int(v) for v in proj[0])
            b = tuple(int(v) for v in proj[1])
            cv2.line(img, a, b, color, max(int(2 * r * s), 2), cv2.LINE_AA)

    def _hull(self, img, corners, color, cam):
        import cv2

        for proj in self._both_views(corners, cam):
            hull = cv2.convexHull(proj.astype(np.int32))
            cv2.fillPoly(img, [hull], color, cv2.LINE_AA)
            cv2.polylines(img, [hull], True,
                          tuple(int(0.6 * c) for c in color), 1, cv2.LINE_AA)

    # ---- output ---------------------------------------------------------- #

    def save(self, path: str) -> str:
        import cv2

        assert self.frames, "no frames recorded"
        wr = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (self.w, self.h)
        )
        assert wr.isOpened(), f"VideoWriter failed to open {path}"
        for f in self.frames:
            wr.write(f)
        wr.release()
        return path
