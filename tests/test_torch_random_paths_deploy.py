"""The production recipe's random draws held to the JAX package's laws.

`humanoid_joint_deploy` is XBot-L and XBot-S in one batch, each on the
deployment heightfield's windows (20 rows, every level from the start,
the survival curriculum, slope DR). Each of its draw sites draws a large
sample through the JAX package and through the port, robot by robot, and
the two samples are compared with the rule of test_torch_random_paths.py
(a KS statistic, the means and the variances at a false-alarm rate of
1e-4 each, and the closed form where the config fixes one):

- the initial level, uniform on 0..max_init_terrain_level = 20 (a level
  of 20 stands on the top row, 19);
- the terrain type spread over the sub-env's index, the deploy field's
  origins, and the spawn about the origin;
- the contact DR (friction, added mass, stiffness, offset, compliance)
  and the slope bias of the deploy style;
- the commands at init;
- the survival curriculum's re-entry level past the top row, and the
  reset pose at the new origin.

The init sites read one `init_state` sample of 2048 + 2048 envs; the
re-entry site steps 1024 + 1024 envs once from one JAX state carried into
the port with `env_state_from_jax`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from test_torch_random_paths import _compare, _dead_zone, _exact, _np, _port_np, _t, _uniform

from humanoid_gym_tpu import registry as jreg
from humanoid_gym_tpu_torch import registry as treg
from humanoid_gym_tpu_torch.algo.convert import env_state_from_jax

torch.set_num_threads(1)

TASK = "humanoid_joint_deploy"
N_INIT = 4096  # 2048 envs of each robot drawn by init_state
N_STEP = 2048  # 1024 of each stepped
ROBOTS = {"L": 0, "S": 1}


class DeployPair:
    """The joint deploy task built in both packages at `n` envs (solver
    apgd); sub-env 0 is XBot-L, 1 XBot-S."""

    def __init__(self, n):
        def ov(c):
            c.sim.solver.solver_type = "apgd"

        self.jenv, _ = jreg.make_env(TASK, num_envs=n, cfg_overrides=ov)
        self.tenv, _ = treg.make_env(TASK, num_envs=n, cfg_overrides=ov, device="cpu", seed=11)
        assert [e.cfg.asset.name for e in self.tenv.envs] == ["XBot-L", "XBot-S"]
        self.n = n

    def init_states(self, key):
        """Each package's `init_state` (JAX's from `key`): two lists of
        per-robot states, JAX's as numpy, the port's float64 numpy."""
        js = self.jenv.init_state(jax.random.split(jax.random.PRNGKey(key), self.n),
                                  jnp.arange(self.n))
        return [_np(s) for s in js], [_port_np(s) for s in self.tenv.init_state()]


class Lab:
    """The init sample and the re-entry step, each made on first use."""

    def __init__(self):
        self._init = None
        self._step = None

    def init(self):
        if self._init is None:
            p = DeployPair(N_INIT)
            self._init = (p, *p.init_states(21))
        return self._init

    def reentry(self):
        """One step of both packages from one JAX `init_state` state in
        which every env times out at zero command standing on the top row
        (level 19) or past it (20): the survival curriculum promotes each
        one past the top, where it re-enters at a drawn level."""
        if self._step is None:
            p = DeployPair(N_STEP)
            js0 = p.jenv.init_state(jax.random.split(jax.random.PRNGKey(22), p.n),
                                    jnp.arange(p.n))
            carried = []
            for je in p.jenv.envs:
                s = js0[len(carried)]
                m = s.terrain_level.shape[0]
                rows = je.cfg.terrain.num_rows
                lvl = np.where(np.arange(m) % 2 == 0, rows - 1, rows).astype(np.int32)
                origins = np.asarray(je.terrain_origins)
                carried.append(s.replace(
                    episode_length=jnp.full((m,), je.max_episode_length, jnp.int32),
                    terrain_level=jnp.asarray(lvl),
                    env_origin=jnp.asarray(origins[np.minimum(lvl, rows - 1),
                                                   np.asarray(s.terrain_type)]),
                    commands=jnp.zeros_like(s.commands)))
            a = np.zeros((p.n, 12), np.float32)
            js1, jtr = jax.jit(p.jenv.step)(carried, jnp.asarray(a))
            ts1, ttr = p.tenv.step([env_state_from_jax(s) for s in carried], torch.from_numpy(a))
            assert np.asarray(jtr.time_out).all() and bool(ttr.time_out.all())
            self._step = (p, [_np(s) for s in carried], [_np(s) for s in js1],
                          [_port_np(s) for s in ts1])
        return self._step


@pytest.fixture(scope="module")
def lab():
    return Lab()


def site_init_level(lab, r):
    """The initial level: uniform on 0..20 with the curriculum on."""
    p, js, ts = lab.init()
    tc = p.tenv.envs[r].cfg.terrain
    assert tc.curriculum and tc.max_init_terrain_level == 20 == tc.num_rows
    hi = tc.max_init_terrain_level
    return _compare("terrain_level", js[r].terrain_level, ts[r].terrain_level,
                    stats.randint(0, hi + 1), support=np.arange(hi + 1))


def site_origin_and_spawn(lab, r):
    """The types spread over the sub-env's index, the deploy field's
    origins equal, each env at its subterrain's origin (a level of 20 on
    the top row's), the base at the origin plus U(-1, 1) m in x and y and
    the init height in z, the joints at the default plus U(-0.1, 0.1)."""
    p, js, ts = lab.init()
    je, te = p.jenv.envs[r], p.tenv.envs[r]
    j, t = js[r], ts[r]
    rows, cols = te.cfg.terrain.num_rows, te.cfg.terrain.num_cols
    m = len(j.terrain_type)
    out = _exact("terrain_type JAX vs port", j.terrain_type, t.terrain_type, 0.0)
    out += _exact("terrain_type = index * cols // envs", t.terrain_type,
                  np.arange(m) * cols // m, 0.0)
    origins = np.asarray(je.terrain_origins)
    out += _exact("deploy origins JAX vs port", origins, _t(te.terrain_origins), 0.0)
    z0 = te.cfg.init_state.pos[2]
    for side, st in (("JAX", j), ("port", t)):
        lvl = np.minimum(st.terrain_level.astype(int), rows - 1)
        out += _exact(f"env_origin ({side})", st.env_origin,
                      origins[lvl, st.terrain_type.astype(int)])
        out += _exact(f"base z - origin z ({side})", st.phys.qpos[:, 2] - st.env_origin[:, 2], z0,
                      1e-5)
    for a, ax in ((0, "x"), (1, "y")):
        out += _compare(f"base {ax} - origin", j.phys.qpos[:, a] - j.env_origin[:, a],
                        t.phys.qpos[:, a] - t.env_origin[:, a], _uniform(-1.0, 1.0))
    jd, td = np.asarray(je.default_dof_pos), _t(te.default_dof_pos)
    out += _compare("joint offset", j.phys.qpos[:, 7:] - jd, t.phys.qpos[:, 7:] - td,
                    _uniform(-0.1, 0.1))
    return out


def site_contact_dr(lab, r):
    """Friction U(friction_range) and its pair value, the added base mass
    on the robot's range (XBot-S's is XBot-L's x s^3), and the log-uniform
    contact stiffness, offset and compliance of the rubble DR."""
    p, js, ts = lab.init()
    je, te = p.jenv.envs[r], p.tenv.envs[r]
    j, t = js[r], ts[r]
    dr = te.cfg.domain_rand
    assert dr.randomize_friction and dr.randomize_base_mass and not dr.randomize_motor_strength
    assert vars(dr) == vars(je.cfg.domain_rand)
    g = te.cfg.terrain.static_friction
    out = _compare("env_friction", j.env_friction, t.env_friction, _uniform(*dr.friction_range))
    for side, st in (("JAX", j), ("port", t)):
        out += _exact(f"phys.friction ({side})", st.phys.friction, 0.5 * (st.env_friction + g))
        out += _exact(f"kp, kd scales 1 ({side})",
                      np.stack([st.phys.kp_scale, st.phys.kd_scale]), 1.0, 0.0)
    mj, mt = float(np.asarray(je.model.body_mass)[0]), float(te.model.body_mass[0])
    out += _compare("added base mass (kg)", (j.phys.base_mass_scale - 1) * mj,
                    (t.phys.base_mass_scale - 1) * mt, _uniform(*dr.added_mass_range))
    for field, rng in (("contact_stiffness", dr.contact_stiffness_range),
                       ("contact_offset", dr.contact_offset_range),
                       ("contact_compliance", dr.contact_compliance_range)):
        out += _compare(field, getattr(j.phys, field), getattr(t.phys, field),
                        stats.loguniform(*rng))
    return out


def site_slope_bias(lab, r):
    """The deploy style's slope bias, U(contact_slope_range) per axis."""
    p, js, ts = lab.init()
    dr = p.tenv.envs[r].cfg.domain_rand
    assert dr.randomize_contact_slope and p.tenv.envs[r].cfg.terrain.style == "deploy"
    law = _uniform(*dr.contact_slope_range)
    return (_compare("slope_bias x", js[r].phys.slope_bias[:, 0], ts[r].phys.slope_bias[:, 0], law)
            + _compare("slope_bias y", js[r].phys.slope_bias[:, 1], ts[r].phys.slope_bias[:, 1],
                       law))


def site_commands_at_init(lab, r):
    """The commands at init on the robot's ranges (XBot-S's velocities are
    XBot-L's x sqrt(s)): the dead zone, the heading, a zero yaw command."""
    p, js, ts = lab.init()
    cr = p.tenv.envs[r].cfg.commands.ranges
    assert vars(cr) == vars(p.jenv.envs[r].cfg.commands.ranges)
    out = _dead_zone("init command", js[r].commands, ts[r].commands, cr.lin_vel_x, cr.lin_vel_y)
    out += _compare("init heading", js[r].commands[:, 3], ts[r].commands[:, 3],
                    _uniform(*cr.heading))
    for side, st in (("JAX", js[r]), ("port", ts[r])):
        out += _exact(f"init yaw command ({side})", st.commands[:, 2], 0.0, 0.0)
    return out


def site_reentry_level(lab, r):
    """Past the top row the survival curriculum re-enters an env at a level
    uniform on 0..num_rows-1 (JAX envs/env.py:705-710); the reset stands
    it at that level's origin with the reset pose's jitter."""
    p, _, js1, ts1 = lab.reentry()
    je, te = p.jenv.envs[r], p.tenv.envs[r]
    rows = te.cfg.terrain.num_rows
    assert te.cfg.terrain.curriculum_mode == "survival" and te.max_terrain_level == rows
    j, t = js1[r], ts1[r]
    out = _compare("re-entry level", j.terrain_level, t.terrain_level, stats.randint(0, rows),
                   support=np.arange(rows))
    origins = np.asarray(je.terrain_origins)
    for side, st in (("JAX", j), ("port", t)):
        out += _exact(f"reset origin = the new level's ({side})", st.env_origin,
                      origins[st.terrain_level.astype(int), st.terrain_type.astype(int)])
        out += _exact(f"reset episode_length 0 ({side})", st.episode_length, 0.0, 0.0)
    for a, ax in ((0, "x"), (1, "y")):
        out += _compare(f"reset base {ax} - origin", j.phys.qpos[:, a] - j.env_origin[:, a],
                        t.phys.qpos[:, a] - t.env_origin[:, a], _uniform(-1.0, 1.0))
    jd, td = np.asarray(je.default_dof_pos), _t(te.default_dof_pos)
    out += _compare("reset joint offset", j.phys.qpos[:, 7:] - jd, t.phys.qpos[:, 7:] - td,
                    _uniform(-0.1, 0.1))
    return out


SITES = {
    "init_level": site_init_level,
    "origin_and_spawn": site_origin_and_spawn,
    "contact_dr": site_contact_dr,
    "slope_bias": site_slope_bias,
    "commands_at_init": site_commands_at_init,
    "reentry_level": site_reentry_level,
}


@pytest.mark.parametrize("robot", list(ROBOTS))
@pytest.mark.parametrize("site", list(SITES))
def test_deploy_random_path_follows_the_jax_law(site, robot, lab):
    """Each comparison of the site, for the robot, within its limit."""
    checks = SITES[site](lab, ROBOTS[robot])
    bad = [f"{label}: {stat:.4g} > {limit:.4g}" for label, stat, limit in checks
           if not stat <= limit]
    assert not bad, "\n".join(bad)
