"""Interactive policy viewer: live MJPEG stream + keyboard teleop.

Capability analog of the reference's interactive viewer loop
(humanoid/envs/base/base_task.py:104-110 creates a PhysX viewer and
subscribes ESC/QUIT and V/toggle-sync keyboard events; play.py drives it).
It runs on a host with no display and no OpenGL platform, so instead of
a native window the viewer is a tiny HTTP server: the MuJoCo deployment
loop (export/sim2sim.py:174-287 contract) runs in a background thread,
frames are software-rasterized (export/video.py) and streamed as MJPEG to
any browser, and key presses travel back over HTTP — a strict superset of
the reference's viewer keys (quit/pause) plus live velocity-command teleop,
push perturbations, and reset.

Keys (browser window):
  arrows      vx +-0.1 m/s / vy +-0.1 m/s      q / e   yaw rate -+0.2 rad/s
  space       zero all commands                p       push the base (0.5 m/s lateral kick)
  r           reset the robot                  v       pause / resume (reference V toggles sync)
  ESC         quit the server (reference ESC/QUIT)

The PyTorch port's copy of humanoid_gym_tpu/export/live_viewer.py (NumPy,
OpenCV and MuJoCo only): the same MJPEG stream and key map.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<title>humanoid_gym_tpu viewer</title>
<style>body{margin:0;background:#222;color:#ddd;font:14px monospace;text-align:center}
img{max-width:100%}</style>
<h3>humanoid_gym_tpu — live viewer</h3>
<div>arrows: vx/vy &nbsp; q/e: yaw &nbsp; space: stop &nbsp; p: push &nbsp;
r: reset &nbsp; v: pause &nbsp; ESC: quit</div>
<img src="/stream">
<script>
document.addEventListener('keydown', e => {
  fetch('/key?k=' + encodeURIComponent(e.key)).catch(()=>{});
  if (['ArrowUp','ArrowDown','ArrowLeft','ArrowRight',' '].includes(e.key))
    e.preventDefault();
});
</script>
"""


class LiveViewer:
    """Closed-loop MuJoCo rollout with mutable commands and live frames.

    The stepping/obs/PD math is the frozen 47-obs deployment contract
    (export/sim2sim.py get_obs/run_mujoco); only the command source and
    lifetime differ — commands come from `apply_key` instead of a fixed
    Sim2SimCfg, and the loop runs until `stop()`.
    """

    def __init__(self, policy, cfg, fps: int = 25):
        import mujoco

        from .sim2sim import _load_mj_model, _make_hfield_height_fn
        from .video import GaitVideoRenderer

        self._mujoco = mujoco
        self.policy = policy
        self.cfg = cfg
        self.model = _load_mj_model(cfg.mujoco_model_path)
        self.model.opt.timestep = cfg.sim_dt
        self.data = mujoco.MjData(self.model)
        self._height_at = _make_hfield_height_fn(self.model)
        mujoco.mj_step(self.model, self.data)
        self._init_qpos = np.array(self.data.qpos)

        self.renderer = GaitVideoRenderer(self.model, fps=fps)
        self.fps = fps
        self.cmd = np.zeros(3)  # vx, vy, dyaw — mutable teleop state
        self.paused = False
        self.running = True
        self._push = 0.0
        self._lock = threading.Lock()
        self._frame_jpeg: bytes | None = None
        self._frame_event = threading.Event()
        self.sim_time = 0.0
        self._reset_requested = False

        self._target_q = np.zeros(cfg.num_actions)
        self._action = np.zeros(cfg.num_actions)
        self._hist = deque(maxlen=cfg.frame_stack)
        for _ in range(cfg.frame_stack):
            self._hist.append(np.zeros(cfg.num_single_obs))
        self._count = 0

    # ---- teleop ---------------------------------------------------------- #

    def apply_key(self, key: str):
        with self._lock:
            if key == "ArrowUp":
                self.cmd[0] = min(self.cmd[0] + 0.1, 1.0)
            elif key == "ArrowDown":
                self.cmd[0] = max(self.cmd[0] - 0.1, -0.5)
            elif key == "ArrowLeft":
                self.cmd[1] = min(self.cmd[1] + 0.1, 0.5)
            elif key == "ArrowRight":
                self.cmd[1] = max(self.cmd[1] - 0.1, -0.5)
            elif key == "q":
                self.cmd[2] = min(self.cmd[2] + 0.2, 1.0)
            elif key == "e":
                self.cmd[2] = max(self.cmd[2] - 0.2, -1.0)
            elif key == " ":
                self.cmd[:] = 0.0
            elif key == "p":
                self._push = 0.5  # lateral base kick, reference push_robots analog
            elif key == "r":
                self._reset_requested = True
            elif key == "v":
                self.paused = not self.paused
            elif key == "Escape":
                self.running = False

    def stop(self):
        self.running = False

    # ---- simulation ------------------------------------------------------ #

    def _reset(self):
        self.data.qpos[:] = self._init_qpos
        self.data.qvel[:] = 0.0
        self._mujoco.mj_forward(self.model, self.data)
        self._hist.clear()
        for _ in range(self.cfg.frame_stack):
            self._hist.append(np.zeros(self.cfg.num_single_obs))
        self._target_q[:] = 0.0
        self._action[:] = 0.0
        self._count = 0

    def step_policy_window(self):
        """Advance one render frame's worth of sim (1/fps s of 1 kHz steps)."""
        from .sim2sim import get_obs, quaternion_to_euler_array

        cfg = self.cfg
        with self._lock:
            cmd = self.cmd.copy()
            push, self._push = self._push, 0.0
            if self._reset_requested:
                self._reset_requested = False
                self._reset()
        if push:
            self.data.qvel[1] += push
        for _ in range(max(1, int(round(1.0 / (self.fps * cfg.sim_dt))))):
            q, dq, quat, omega = get_obs(self.data)
            qj = q[-cfg.num_actions :]
            dqj = dq[-cfg.num_actions :]
            if self._count % cfg.decimation == 0:
                t = self._count * cfg.sim_dt
                obs = np.zeros(cfg.num_single_obs)
                eu = quaternion_to_euler_array(quat)
                eu[eu > np.pi] -= 2 * np.pi
                phase = 2 * np.pi * t / cfg.cycle_time
                obs[0] = np.sin(phase)
                obs[1] = np.cos(phase)
                obs[2] = cmd[0] * cfg.obs_scale_lin_vel
                obs[3] = cmd[1] * cfg.obs_scale_lin_vel
                obs[4] = cmd[2] * cfg.obs_scale_ang_vel
                obs[5:17] = qj * cfg.obs_scale_dof_pos
                obs[17:29] = dqj * cfg.obs_scale_dof_vel
                obs[29:41] = self._action
                obs[41:44] = omega
                obs[44:47] = eu
                obs = np.clip(obs, -cfg.obs_clip, cfg.obs_clip)
                self._hist.append(obs)
                a = np.asarray(
                    self.policy(np.concatenate(list(self._hist)))
                ).reshape(-1)
                self._action = np.clip(a, -cfg.action_clip, cfg.action_clip)
                self._target_q = self._action * cfg.action_scale
            tau = cfg.kps * (self._target_q - qj) - cfg.kds * dqj
            tau = np.clip(tau, -cfg.tau_limit, cfg.tau_limit)
            self.data.ctrl = tau
            self._mujoco.mj_step(self.model, self.data)
            self._count += 1
        self.sim_time = self._count * cfg.sim_dt

    def render_jpeg(self) -> bytes:
        import cv2

        self.renderer.frames.clear()
        base = self.data.xpos[1]
        ground = self._height_at(float(base[0]), float(base[1]))
        state = "PAUSED" if self.paused else "live"
        self.renderer.add_frame(
            self.data,
            hud=f"t={self.sim_time:6.2f}s  cmd=({self.cmd[0]:+.1f},"
            f"{self.cmd[1]:+.1f},{self.cmd[2]:+.1f})  vx={self.data.qvel[0]:+.2f}"
            f"  clearance={base[2] - ground:.2f}m  [{state}]",
        )
        ok, buf = cv2.imencode(".jpg", self.renderer.frames[-1],
                               [cv2.IMWRITE_JPEG_QUALITY, 80])
        assert ok
        return buf.tobytes()

    def run(self, realtime: bool = True):
        """Sim loop: fills `self._frame_jpeg` at `fps` until stopped."""
        period = 1.0 / self.fps
        while self.running:
            t0 = time.monotonic()
            if not self.paused:
                self.step_policy_window()
            self._frame_jpeg = self.render_jpeg()
            self._frame_event.set()
            if realtime:
                time.sleep(max(0.0, period - (time.monotonic() - t0)))

    # ---- HTTP ------------------------------------------------------------ #

    def serve(self, host: str = "127.0.0.1", port: int = 8800):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/key"):
                    from urllib.parse import parse_qs, urlparse

                    k = parse_qs(urlparse(self.path).query).get("k", [""])[0]
                    viewer.apply_key(k)
                    self.send_response(204)
                    self.end_headers()
                elif self.path.startswith("/stream"):
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    try:
                        while viewer.running:
                            viewer._frame_event.wait(timeout=1.0)
                            viewer._frame_event.clear()
                            jpg = viewer._frame_jpeg
                            if jpg is None:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                b"Content-Length: %d\r\n\r\n" % len(jpg)
                            )
                            self.wfile.write(jpg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

        server = ThreadingHTTPServer((host, port), Handler)
        server.timeout = 0.5
        sim_thread = threading.Thread(target=self.run, daemon=True)
        sim_thread.start()
        try:
            while self.running:
                server.handle_request()
        finally:
            self.running = False
            server.server_close()
            sim_thread.join(timeout=2.0)
