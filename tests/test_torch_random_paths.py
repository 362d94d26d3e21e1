"""The port's random draws held to the JAX package's laws.

JAX's threefry streams and torch's generators never produce the same
numbers, so the parity tests of the env step (test_torch_env.py) run with
every random feature off. Here each random draw site of the training path
draws a large sample through the JAX package and through the port, and the
two samples are compared: a two-sample Kolmogorov-Smirnov statistic, the
difference of the means and the difference of the variances. Where the
config fixes a closed form (a uniform, a log-uniform, a discrete uniform,
a standard normal), both samples are also held to it.

Every quantity is read off what the path itself returns: the state after
`init_state`, after `step`, or after the runner's `learn` starts. A step
site starts from one JAX `reset_all` state carried into the port with
`env_state_from_jax`, with the site's feature switched on by a config
override (a push or a command resample on every second step, say).

Tolerances follow from the sample size. Every comparison has a false-alarm
rate of ALPHA = 1e-4 for a sample that does follow the law: the KS limit is
sqrt(-ln(ALPHA / 2) / 2) * sqrt(1/n + 1/m) (2.23 / sqrt(n) against a
closed form); a mean or a variance may differ by Z = 3.89 standard errors,
the error of a variance taken from the law's kurtosis. A discrete law is
compared at its support points, where the KS statistic is exact."""

import dataclasses
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from humanoid_gym_tpu import registry as jreg
from humanoid_gym_tpu.runner.on_policy_runner import OnPolicyRunner as JaxRunner
from humanoid_gym_tpu_torch import registry as treg
from humanoid_gym_tpu_torch.algo.convert import env_state_from_jax
from humanoid_gym_tpu_torch.runner.on_policy_runner import OnPolicyRunner as TorchRunner

# The tensors here are small: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)

ALPHA = 1e-4  # false-alarm rate of each comparison
KS_C = math.sqrt(-math.log(ALPHA / 2) / 2)
Z = float(stats.norm.isf(ALPHA / 2))
N_INIT = 4096  # envs drawn by init_state alone
N_STEP = 2048  # envs stepped (the physics makes these dearer)
FLAT, TERRAIN = "humanoid_ppo", "humanoid_ppo_terrain_robust"


# ------------------------------------------------------------ comparisons


def _ks_discrete(x, support, cdf):
    """sup |F_n - F| over the support of a discrete law (exact there)."""
    ecdf = np.searchsorted(np.sort(x), support, side="right") / len(x)
    return float(np.max(np.abs(ecdf - cdf(support))))


def _ks_discrete_2samp(a, b, support):
    sa, sb = np.sort(a), np.sort(b)
    fa = np.searchsorted(sa, support, side="right") / len(a)
    fb = np.searchsorted(sb, support, side="right") / len(b)
    return float(np.max(np.abs(fa - fb)))


def _var_se(x, var, excess_kurtosis):
    """Standard error of the sample variance of len(x) draws."""
    return var * math.sqrt((excess_kurtosis + 2.0) / len(x))


def _compare(name, j, t, law=None, support=None):
    """The checks of one quantity, each (label, statistic, limit): JAX's
    sample `j` against the port's `t`, and, where `law` (a frozen scipy
    distribution) is given, each sample against it. `support`: the
    values of a discrete law."""
    j = np.asarray(j, np.float64).ravel()
    t = np.asarray(t, np.float64).ravel()
    n, m = len(j), len(t)
    if support is None:
        d = stats.ks_2samp(j, t).statistic
    else:
        d = _ks_discrete_2samp(j, t, support)
    out = [(f"{name}: KS JAX vs port", d, KS_C * math.sqrt(1 / n + 1 / m)),
           (f"{name}: mean JAX - port", abs(j.mean() - t.mean()),
            Z * math.sqrt(j.var() / n + t.var() / m))]
    kj, kt = stats.kurtosis(j), stats.kurtosis(t)
    out.append((f"{name}: variance JAX - port", abs(j.var() - t.var()),
                Z * math.hypot(_var_se(j, j.var(), kj), _var_se(t, t.var(), kt))))
    if law is not None:
        mu, var, _, kurt = (float(v) for v in law.stats(moments="mvsk"))
        for side, x in (("JAX", j), ("port", t)):
            if support is None:
                dk = stats.kstest(x, law.cdf).statistic
            else:
                dk = _ks_discrete(x, support, law.cdf)
            out += [(f"{name}: KS {side} vs law", dk, KS_C / math.sqrt(len(x))),
                    (f"{name}: mean {side} - law", abs(x.mean() - mu),
                     Z * math.sqrt(var / len(x))),
                    (f"{name}: variance {side} - law", abs(x.var() - var),
                     Z * _var_se(x, var, kurt))]
    return out


def _exact(name, got, want, atol=1e-6):
    """A deterministic relation both packages must keep (label, max error,
    limit)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return [(f"{name}", float(np.max(np.abs(got - want))) if got.size else 0.0, atol)]


def _uniform(lo, hi):
    return stats.uniform(lo, hi - lo)


def _dead_zone_kept_cdf(box, r, a):
    """CDF of one command component given that the pair (vx, vy), uniform
    on box = ((x0, x1), (y0, y1)), lies outside the disk of radius r about
    0 (the resampler's dead zone, inside the box). `a`: 0 for vx, 1 for
    vy."""
    (x0, x1), (y0, y1) = box
    lo, other = (x0, y1 - y0) if a == 0 else (y0, x1 - x0)
    kept = (x1 - x0) * (y1 - y0) - math.pi * r * r

    def cdf(x):
        u = np.clip(x, -r, r)
        disk = u * np.sqrt(r * r - u * u) + r * r * (np.arcsin(u / r) + math.pi / 2)
        return ((np.asarray(x) - lo) * other - disk) / kept

    return cdf


def _dead_zone(name, cj, ct, vx_range, vy_range, r=0.2):
    """Commands (N, >=2) of both packages: the share of zeroed pairs
    against the closed form, each kept component against its conditional
    law, and the two-sample checks on the raw components."""
    box = (tuple(vx_range), tuple(vy_range))
    p0 = math.pi * r * r / ((box[0][1] - box[0][0]) * (box[1][1] - box[1][0]))
    out = []
    kept = {}
    for side, c in (("JAX", cj), ("port", ct)):
        c = np.asarray(c, np.float64)
        zero = (c[:, 0] == 0) & (c[:, 1] == 0)
        out.append((f"{name}: zeroed share {side} - {p0:.4f}", abs(zero.mean() - p0),
                    Z * math.sqrt(p0 * (1 - p0) / len(c))))
        kept[side] = c[~zero]
        out += _exact(f"{name}: kept pairs outside the dead zone ({side})",
                      np.minimum(np.hypot(c[~zero, 0], c[~zero, 1]) - r, 0.0), 0.0)
    for a, comp in ((0, "vx"), (1, "vy")):
        cdf = _dead_zone_kept_cdf(box, r, a)
        for side in ("JAX", "port"):
            x = kept[side][:, a]
            out.append((f"{name}: KS kept {comp} {side} vs law", stats.kstest(x, cdf).statistic,
                        KS_C / math.sqrt(len(x))))
        out += _compare(f"{name}: {comp}", np.asarray(cj)[:, a], np.asarray(ct)[:, a])
    return out


# ------------------------------------------------------------ the two envs


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return x.detach().cpu().numpy().astype(np.float64)


def _port_np(st):
    """The port's EnvState with float64 numpy leaves, phys too."""
    leaves = lambda obj: {f.name: _t(getattr(obj, f.name))  # noqa: E731
                          for f in dataclasses.fields(obj) if f.name != "phys"}
    return SimpleNamespace(phys=SimpleNamespace(**leaves(st.phys)), **leaves(st))


class Pair:
    """One task built in both packages from the same overrides."""

    def __init__(self, task, n, override=None):
        def ov(c):
            c.sim.solver.solver_type = "apgd"
            if override is not None:
                override(c)

        self.jenv, _ = jreg.make_env(task, num_envs=n, cfg_overrides=ov)
        self.tenv, self.tcfg = treg.make_env(task, num_envs=n, cfg_overrides=ov, device="cpu",
                                             seed=11)
        self.n = n
        self._jstep = jax.jit(self.jenv.step)

    def init_states(self, key=0):
        """The states `init_state` draws in each package (JAX's from `key`),
        as numpy."""
        n = self.n
        js = jax.jit(self.jenv.init_state)(jax.random.split(jax.random.PRNGKey(key), n),
                                           jnp.arange(n))
        return _np(js), _port_np(self.tenv.init_state())

    def reset_state(self, key=0):
        """One JAX `reset_all` state, as numpy leaves (the port's copy is
        made from it with `env_state_from_jax`)."""
        js, _, _ = self.jenv.reset_all(jax.random.PRNGKey(key))
        return _np(js)

    def step(self, js, ts, actions):
        """One step of each package from its own state: (JAX state, JAX
        transition, port state, port transition), JAX's as numpy."""
        a = np.asarray(actions, np.float32)
        js, jtr = self._jstep(js, jnp.asarray(a))
        ts, ttr = self.tenv.step(ts, torch.from_numpy(a))
        return _np(js), _np(jtr), ts, ttr


def _motor_on(c):
    c.domain_rand.randomize_motor_strength = True


def _step_sites(c):
    """A push and a command resample on every second policy step."""
    c.domain_rand.push_interval_s = 1.5 * c.dt
    c.commands.resampling_time = 2 * c.dt


PAIR_SPECS = {
    "flat_init": (FLAT, N_INIT, _motor_on),
    "terrain_init": (TERRAIN, N_INIT, None),
    "flat_step": (FLAT, N_STEP, _step_sites),
    "terrain_step": (TERRAIN, N_STEP, None),
    "runner": (FLAT, N_STEP, None),
}


class Lab:
    """The env pairs of PAIR_SPECS, each built on first use, and the two
    flat steps several sites read."""

    def __init__(self):
        self._pairs = {}
        self._flat_steps = None

    def pair(self, key):
        if key not in self._pairs:
            self._pairs[key] = Pair(*PAIR_SPECS[key])
        return self._pairs[key]

    def flat_steps(self):
        """Two steps of `flat_step` from one carried reset_all state (after
        it, common_step and episode_length are 1, so the first step pushes
        and resamples and the second does neither), each side's states and
        transitions as numpy. The previous actions are 1 on joints 0-5 and
        0 on 6-11, the policy action 1 on all: on joints 0-5 the delay mix
        is 1 whatever the delay, so the stored action is 1 + action_noise *
        z; on joints 6-11 it is (1 - d)(1 + action_noise * z)."""
        if self._flat_steps is None:
            p = self.pair("flat_step")
            js0 = p.reset_state(10)
            prev = np.zeros((p.n, 12), np.float32)
            prev[:, :6] = 1.0
            js0 = js0.replace(actions=prev, ref_dof_pos=np.zeros_like(js0.ref_dof_pos))
            ts = env_state_from_jax(js0)
            js, ones, steps = js0, np.ones((p.n, 12), np.float32), []
            for _ in range(2):
                js, jtr, ts, ttr = p.step(js, ts, ones)
                steps.append((js, jtr, _port_np(ts), SimpleNamespace(
                    obs=_t(ttr.obs), done=ttr.done.numpy(), time_out=ttr.time_out.numpy())))
            self._flat_steps = (p, js0, *steps)
        return self._flat_steps


@pytest.fixture(scope="module")
def lab():
    return Lab()


# ------------------------------------------------------------ the sites


def site_init_pose_and_xy(lab):
    """`_reset_phys` in `init_state`: joints at the default angles plus
    U(-0.1, 0.1); on terrain the base at the subterrain origin plus
    U(-1, 1) m in x and y (flat: at the init position exactly)."""
    p = lab.pair("terrain_init")
    js, ts = p.init_states(1)
    jd, td = np.asarray(p.jenv.default_dof_pos), _t(p.tenv.default_dof_pos)
    out = _compare("joint offset", js.phys.qpos[:, 7:] - jd, ts.phys.qpos[:, 7:] - td,
                   _uniform(-0.1, 0.1))
    for a, ax in ((0, "x"), (1, "y")):
        out += _compare(f"base {ax} - origin", js.phys.qpos[:, a] - js.env_origin[:, a],
                        ts.phys.qpos[:, a] - ts.env_origin[:, a], _uniform(-1.0, 1.0))
    z0 = p.tcfg.init_state.pos[2]
    for side, st in (("JAX", js), ("port", ts)):
        out += _exact(f"base z - origin z ({side})", st.phys.qpos[:, 2] - st.env_origin[:, 2], z0,
                      1e-5)
    f = lab.pair("flat_init")
    for side, st in zip(("JAX", "port"), f.init_states(2)):
        out += _exact(f"flat base xy ({side})", st.phys.qpos[:, :2], f.tcfg.init_state.pos[:2])
    return out


def site_friction(lab):
    """Friction: the JAX package picks one of 256 per-env uniform buckets,
    the port draws the uniform directly; both are U(friction_range), and
    the solver's pair value is the mean with the ground's."""
    p = lab.pair("flat_init")
    js, ts = p.init_states(3)
    lo, hi = p.tcfg.domain_rand.friction_range
    g = p.tcfg.terrain.static_friction
    out = _compare("env_friction", js.env_friction, ts.env_friction, _uniform(lo, hi))
    for side, st in (("JAX", js), ("port", ts)):
        out += _exact(f"phys.friction ({side})", st.phys.friction, 0.5 * (st.env_friction + g))
    return out


def site_added_mass(lab):
    p = lab.pair("flat_init")
    js, ts = p.init_states(4)
    mj = float(np.asarray(p.jenv.model.body_mass)[0])
    mt = float(p.tenv.model.body_mass[0])
    return _compare("added base mass (kg)", (js.phys.base_mass_scale - 1) * mj,
                    (ts.phys.base_mass_scale - 1) * mt,
                    _uniform(*p.tcfg.domain_rand.added_mass_range))


def site_contact_dr(lab):
    """Contact stiffness, offset and compliance: log-uniform over their
    ranges (`humanoid_ppo_terrain_robust`)."""
    p = lab.pair("terrain_init")
    js, ts = p.init_states(5)
    dr = p.tcfg.domain_rand
    assert dr.randomize_contact_stiffness and dr.randomize_contact_offset
    assert dr.randomize_contact_compliance
    out = []
    for field, rng in (("contact_stiffness", dr.contact_stiffness_range),
                       ("contact_offset", dr.contact_offset_range),
                       ("contact_compliance", dr.contact_compliance_range)):
        out += _compare(field, getattr(js.phys, field), getattr(ts.phys, field),
                        stats.loguniform(*rng))
    return out


def site_motor_strength(lab):
    p = lab.pair("flat_init")
    js, ts = p.init_states(6)
    law = _uniform(*p.tcfg.domain_rand.motor_strength_range)
    return (_compare("kp_scale", js.phys.kp_scale, ts.phys.kp_scale, law)
            + _compare("kd_scale", js.phys.kd_scale, ts.phys.kd_scale, law))


def site_slope_bias(lab):
    p = lab.pair("terrain_init")
    js, ts = p.init_states(7)
    assert p.tcfg.domain_rand.randomize_contact_slope
    law = _uniform(*p.tcfg.domain_rand.contact_slope_range)
    return (_compare("slope_bias x", js.phys.slope_bias[:, 0], ts.phys.slope_bias[:, 0], law)
            + _compare("slope_bias y", js.phys.slope_bias[:, 1], ts.phys.slope_bias[:, 1], law))


def site_terrain_level_and_type(lab):
    """The initial level is uniform on 0..max_init_terrain_level, the type
    spread over the env index, the origin that subterrain's (a level past
    the top row on the top row's)."""
    p = lab.pair("terrain_init")
    js, ts = p.init_states(8)
    tc = p.tcfg.terrain
    hi = tc.max_init_terrain_level
    out = _compare("terrain_level", js.terrain_level, ts.terrain_level,
                   stats.randint(0, hi + 1), support=np.arange(hi + 1))
    out += _exact("terrain_type JAX vs port", js.terrain_type, ts.terrain_type, 0.0)
    origins = np.asarray(p.jenv.terrain_origins)
    out += _exact("terrain origins JAX vs port", origins, _t(p.tenv.terrain_origins), 0.0)
    for side, st in (("JAX", js), ("port", ts)):
        lvl = np.minimum(st.terrain_level.astype(int), tc.num_rows - 1)
        out += _exact(f"env_origin ({side})", st.env_origin,
                      origins[lvl, st.terrain_type.astype(int)])
    return out


def site_commands_at_init(lab):
    """`_sample_commands` at init: vx on lin_vel_x, vy on lin_vel_y, the
    heading on its range, the yaw command 0; a pair inside 0.2 m/s is
    zeroed."""
    p = lab.pair("flat_init")
    js, ts = p.init_states(9)
    cr = p.tcfg.commands.ranges
    assert p.tcfg.commands.heading_command
    out = _dead_zone("init command", js.commands, ts.commands, cr.lin_vel_x, cr.lin_vel_y)
    out += _compare("init heading", js.commands[:, 3], ts.commands[:, 3], _uniform(*cr.heading))
    for side, st in (("JAX", js), ("port", ts)):
        out += _exact(f"init yaw command ({side})", st.commands[:, 2], 0.0, 0.0)
    return out


def _kept(*transitions):
    """Envs that reset in none of these steps, in either package."""
    return ~np.any([np.asarray(tr.done) for tr in transitions], axis=0)


def site_commands_at_resample(lab):
    """`_sample_commands` on a resample step (the per-env vx range of the
    state), and no resample off it."""
    p, js0, (js1, jtr1, ts1, ttr1), (js2, jtr2, ts2, ttr2) = lab.flat_steps()
    k = _kept(jtr1, ttr1, jtr2, ttr2)
    assert k.mean() > 0.95
    cr = p.tcfg.commands.ranges
    assert np.all(np.asarray(js0.cmd_vx_range) == np.asarray(cr.lin_vel_x, np.float32))
    out = _dead_zone("resampled command", js1.commands[k], ts1.commands[k], cr.lin_vel_x,
                     cr.lin_vel_y)
    out += _compare("resampled heading", js1.commands[k, 3], ts1.commands[k, 3],
                    _uniform(*cr.heading))
    for side, s1, s2 in (("JAX", js1, js2), ("port", ts1, ts2)):
        out += _exact(f"no resample off the interval ({side})", s2.commands[k][:, [0, 1, 3]],
                      s1.commands[k][:, [0, 1, 3]], 0.0)
    return out


def _delay_law(d_max, sigma, k):
    """(CDF, mean, variance) of 1 - mean_k((1 - d)(1 + sigma z_i)), d ~
    U(0, d_max), z_i standard normal: d - (1 - d) sigma zbar, zbar ~ N(0,
    1/k)."""
    d = np.linspace(0.0, d_max, 4001)

    def cdf(x):
        x = np.atleast_1d(np.asarray(x, np.float64))
        s = (1 - d)[None] * sigma / math.sqrt(k)
        return np.trapezoid(stats.norm.cdf((x[:, None] - d[None]) / s), d, axis=1) / d_max

    var = d_max ** 2 / 12 + sigma ** 2 / k * (1 - d_max + d_max ** 2 / 3)
    return cdf, d_max / 2, var


def site_action_delay_and_noise(lab):
    """The action pipeline: delay d ~ U(0, action_delay) per env mixes the
    previous action in, then a multiplicative N(0, action_noise) per
    joint. Joints 0-5 give the noise exactly; the mean over joints 6-11
    gives d to within (1 - d) action_noise / sqrt(6), and is held to that
    convolution."""
    p, _, (js1, jtr1, ts1, ttr1), _ = lab.flat_steps()
    dr = p.tcfg.domain_rand
    k = _kept(jtr1, ttr1)
    assert k.mean() > 0.95
    aj, at = js1.actions[k], ts1.actions[k]
    out = _compare("action noise z", (aj[:, :6] - 1) / dr.action_noise,
                   (at[:, :6] - 1) / dr.action_noise, stats.norm())
    dj, dt = 1 - aj[:, 6:].mean(1), 1 - at[:, 6:].mean(1)
    out += _compare("delay estimate", dj, dt)
    cdf, mean, var = _delay_law(dr.action_delay, dr.action_noise, 6)
    for side, x in (("JAX", dj), ("port", dt)):
        out += [(f"delay estimate: KS {side} vs law", stats.kstest(x, cdf).statistic,
                 KS_C / math.sqrt(len(x))),
                (f"delay estimate: mean {side} - law", abs(x.mean() - mean),
                 Z * math.sqrt(var / len(x)))]
    return out


def site_pushes(lab):
    """A push step sets the base's linear xy and angular velocity to
    U(+-max_push_vel_xy) and U(+-max_push_ang_vel) and records them in
    rand_push_*; a step off the interval leaves both alone."""
    p, _, (js1, jtr1, ts1, ttr1), (js2, jtr2, ts2, ttr2) = lab.flat_steps()
    dr = p.tcfg.domain_rand
    k = _kept(jtr1, ttr1)
    assert k.mean() > 0.95
    out = []
    for a in (0, 1):
        out += _compare(f"push v_{'xy'[a]}", js1.rand_push_force[:, a], ts1.rand_push_force[:, a],
                        _uniform(-dr.max_push_vel_xy, dr.max_push_vel_xy))
    for a in range(3):
        out += _compare(f"push w_{'xyz'[a]}", js1.rand_push_torque[:, a],
                        ts1.rand_push_torque[:, a],
                        _uniform(-dr.max_push_ang_vel, dr.max_push_ang_vel))
    for side, s1, s2 in (("JAX", js1, js2), ("port", ts1, ts2)):
        out += _exact(f"qvel[0:2] = push ({side})", s1.phys.qvel[k, 0:2],
                      s1.rand_push_force[k, :2], 0.0)
        out += _exact(f"qvel[3:6] = push ({side})", s1.phys.qvel[k, 3:6], s1.rand_push_torque[k],
                      0.0)
        out += _exact(f"push force z = 0 ({side})", s1.rand_push_force[:, 2], 0.0, 0.0)
        out += _exact(f"no push off the interval ({side})",
                      np.concatenate([s2.rand_push_force, s2.rand_push_torque], 1),
                      np.concatenate([s1.rand_push_force, s1.rand_push_torque], 1), 0.0)
    return out


def site_observation_noise(lab):
    """The newest observation frame minus the noise-free frame of the
    returned state, over noise_scale_vec * noise_level: a standard normal
    on the 30 noisy entries, zero on the others."""
    p, _, (js1, jtr1, ts1, ttr1), _ = lab.flat_steps()
    cfg = p.tcfg
    os_ = cfg.normalization.obs_scales
    scale = _t(p.tenv.noise_scale_vec) * cfg.noise.noise_level
    noisy = scale > 0
    assert noisy.sum() == 30
    default = _t(p.tenv.default_dof_pos)
    z, out = {}, []
    for side, st, obs in (("JAX", js1, jtr1.obs), ("port", ts1, ttr1.obs)):
        phase = np.asarray(st.episode_length, np.float64) * p.tenv.dt / cfg.rewards.cycle_time
        qpos, qvel = np.asarray(st.phys.qpos), np.asarray(st.phys.qvel)
        clean = np.concatenate([
            np.sin(2 * np.pi * phase)[:, None], np.cos(2 * np.pi * phase)[:, None],
            np.asarray(st.commands)[:, :3] * [os_.lin_vel, os_.lin_vel, os_.ang_vel],
            (qpos[:, 7:] - default) * os_.dof_pos, qvel[:, 6:] * os_.dof_vel,
            np.asarray(st.actions), np.asarray(st.base_ang_vel) * os_.ang_vel,
            np.asarray(st.base_euler) * os_.quat], axis=1)
        newest = np.asarray(obs, np.float64).reshape(p.n, -1, cfg.env.num_single_obs)[:, -1]
        out += _exact(f"noise-free entries ({side})", (newest - clean)[:, ~noisy], 0.0, 1e-5)
        z[side] = (newest - clean)[:, noisy] / scale[noisy]
    return out + _compare("observation noise z", z["JAX"], z["port"], stats.norm())


def site_reset_pose_and_level(lab):
    """A reset on a time-out: the envs stand on the top row with no
    command, so the survival curriculum moves each one past the top and it
    re-enters at a level uniform on 0..num_rows-1; the reset pose is the
    default joints plus U(-0.1, 0.1) at the new origin plus U(-1, 1) m."""
    p = lab.pair("terrain_step")
    tc = p.tcfg.terrain
    assert tc.curriculum_mode == "survival"
    assert p.tenv.max_episode_length == p.jenv.max_episode_length
    js0 = p.reset_state(12)
    top = np.full(p.n, tc.num_rows - 1, np.int32)
    origins = np.asarray(p.jenv.terrain_origins)
    js0 = js0.replace(
        episode_length=np.full(p.n, p.jenv.max_episode_length, np.int32),
        terrain_level=top, env_origin=origins[top, np.asarray(js0.terrain_type)],
        commands=np.zeros_like(js0.commands))
    js1, jtr1, ts1, ttr1 = p.step(js0, env_state_from_jax(js0), np.zeros((p.n, 12), np.float32))
    assert np.asarray(jtr1.time_out).all() and bool(ttr1.time_out.all())
    ts1 = _port_np(ts1)
    out = _compare("re-entry level", js1.terrain_level, ts1.terrain_level,
                   stats.randint(0, tc.num_rows), support=np.arange(tc.num_rows))
    jd, td = np.asarray(p.jenv.default_dof_pos), _t(p.tenv.default_dof_pos)
    out += _compare("reset joint offset", js1.phys.qpos[:, 7:] - jd, ts1.phys.qpos[:, 7:] - td,
                    _uniform(-0.1, 0.1))
    for a, ax in ((0, "x"), (1, "y")):
        out += _compare(f"reset base {ax} - origin", js1.phys.qpos[:, a] - js1.env_origin[:, a],
                        ts1.phys.qpos[:, a] - ts1.env_origin[:, a], _uniform(-1.0, 1.0))
    for side, st in (("JAX", js1), ("port", ts1)):
        out += _exact(f"reset origin = the new level's ({side})", st.env_origin,
                      origins[st.terrain_level.astype(int), st.terrain_type.astype(int)])
        out += _exact(f"reset episode_length 0 ({side})", st.episode_length, 0.0, 0.0)
    return out


def site_runner_episode_lengths(lab):
    """`learn(..., init_at_random_ep_len=True)`: each env's episode length
    uniform on 0..max_episode_length-1 before the first iteration."""
    p = lab.pair("runner")
    jr = JaxRunner(p.jenv, jreg.get_task(FLAT).make_train_cfg(), log_dir=None)
    tr = TorchRunner(p.tenv, treg.get_task(FLAT).make_train_cfg(), log_dir=None)
    jr.learn(0, init_at_random_ep_len=True)
    tr.learn(0, init_at_random_ep_len=True)
    hi = p.jenv.max_episode_length
    assert hi == p.tenv.max_episode_length
    return _compare("initial episode_length", np.asarray(jr.env_state.episode_length),
                    _t(tr.env_state.episode_length), stats.randint(0, hi),
                    support=np.arange(hi))


SITES = {
    "init_pose_and_xy": site_init_pose_and_xy,
    "friction": site_friction,
    "added_mass": site_added_mass,
    "contact_dr": site_contact_dr,
    "motor_strength": site_motor_strength,
    "slope_bias": site_slope_bias,
    "terrain_level_and_type": site_terrain_level_and_type,
    "commands_at_init": site_commands_at_init,
    "commands_at_resample": site_commands_at_resample,
    "action_delay_and_noise": site_action_delay_and_noise,
    "pushes": site_pushes,
    "reset_pose_and_level": site_reset_pose_and_level,
    "observation_noise": site_observation_noise,
    "runner_episode_lengths": site_runner_episode_lengths,
}


@pytest.mark.parametrize("site", list(SITES))
def test_random_path_follows_the_jax_law(site, lab):
    """Each comparison of the site within its limit (the module's
    docstring says how the limits follow from the sample sizes)."""
    checks = SITES[site](lab)
    bad = [f"{label}: {stat:.4g} > {limit:.4g}" for label, stat, limit in checks
           if not stat <= limit]
    assert not bad, "\n".join(bad)
