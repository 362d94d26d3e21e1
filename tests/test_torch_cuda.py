"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips, with the reason, where torch sees no CUDA
card (the CPU tier). On the GPU machine run them with
`python -m pytest tests/test_torch_cuda.py -q`; chip_smoke.py makes the
same checks at the main path's full width.
"""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a and run only there")
    return torch.device("cuda")


def _states(model, n, dev):
    from humanoid_gym_tpu_torch.physics.step import default_state

    rng = np.random.default_rng(0)
    st = default_state(model, n, [0.0, 0.0, 0.9], [1.0, 0.0, 0.0, 0.0])
    qpos = st.qpos.cpu().numpy()
    qpos[:, 7:] = rng.uniform(-0.1, 0.1, (n, 12))
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    st = st.replace(qpos=f(qpos), qvel=f(rng.normal(size=(n, 18)) * 0.2),
                    friction=f(rng.uniform(0.3, 1.2, n)),
                    contact_compliance=f(rng.uniform(0.0, 0.2, n)))
    return st, f(rng.uniform(-0.2, 0.2, (n, 12)))


def _gains(model, dev):
    kp = torch.tensor([200, 200, 350, 350, 15, 15] * 2, dtype=torch.float32, device=dev)
    kd = torch.full((12,), 10.0, device=dev)
    return kp, kd, model.dof_effort * 0.85


def _mega_and_solve_match_plain(model, st, tgt, dev):
    """One policy step of the mega kernel within the chip_smoke tolerances of
    the plain version (qpos 5e-4, qvel 1e-2, lam and ff 5 N x dt, tau 5e-2,
    fk14 5e-4), the stand-alone solve within qvel 5e-4, lam 2e-3, all finite;
    each wrapper counts one launch. Returns the plain outputs and the
    solve's operands."""
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.physics import solve as SV

    n = st.qpos.shape[0]
    kp, kd, tl = _gains(model, dev)
    args = (st.qpos, st.qvel, st.friction, st.base_mass_scale, st.contact_stiffness,
            st.contact_offset, st.kp_scale, st.kd_scale, st.contact_compliance, st.contact_lam, tgt)
    step = MG.make_mega_step_batched(model, 0.001, 10, kp, kd, tl, iterations=8)
    n0 = MG.mega_kernel_launch.launches
    got = step(*args[:10], st.slope_bias, args[10])
    assert MG.mega_kernel_launch.launches == n0 + 1
    want = MG.mega_step_plain(model, 0.001, 10, kp, kd, tl, 8, 1.0, *args)
    for g, w, tol in zip(got, want, (5e-4, 1e-2, 5e-3, 5e-2, 5e-3, 5e-4)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= tol
    ms = torch.ones((n, 13), device=dev)
    _, ops, _ = MG.solve_operands(model, 0.001, st.qpos, st.qvel, tgt, kp, kd, tl, ms, st.friction,
                               st.contact_stiffness, st.contact_offset, st.contact_compliance,
                               st.contact_lam)
    s0 = SV.fused_solve.launches
    q, lam = SV.fused_solve(*ops, iterations=8)
    assert SV.fused_solve.launches == s0 + 1
    q_p, lam_p = SV.fused_solve_plain(*ops, iterations=8)
    assert q.shape == (n, 18) and lam.shape == (n, 60)
    assert bool(torch.isfinite(q).all() and torch.isfinite(lam).all())
    assert float((q - q_p).abs().max()) <= 5e-4
    assert float((lam - lam_p).abs().max()) <= 2e-3
    return want, ops


@pytest.mark.parametrize("n", [300, 37, 1])
def test_mega_and_solve_kernels_match_plain(dev, n):
    """300 envs, 37 (a ragged last block: the kernels give each env a warp
    and a block several envs) and 1, one policy step: the kernel within the
    chip_smoke tolerances of the plain version (qpos 5e-4, qvel 1e-2, tau
    5e-2), and the stand-alone solve within qvel 5e-4, lam 2e-3; counters
    count."""
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    model = build_xbot_model().to(dev)
    st, tgt = _states(model, n, dev)
    _mega_and_solve_match_plain(model, st, tgt, dev)


def test_mega_and_solve_kernels_with_no_active_contact_row(dev):
    """Robots lifted a metre above the ground: every contact row carries the
    inactive sentinel -1e9, the impulses stay zero, and the kernels stay
    finite and inside the same tolerances."""
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    model = build_xbot_model().to(dev)
    st, tgt = _states(model, 64, dev)
    qpos = st.qpos.clone()
    qpos[:, 2] += 1.0
    want, ops = _mega_and_solve_match_plain(model, st.replace(qpos=qpos), tgt, dev)
    assert bool((ops[4][:, 2:48:3] == -1e9).all())
    assert float(want[2][:, :48].abs().max()) == 0.0


def test_mega_and_solve_kernels_with_all_limit_rows_inactive(dev):
    """Every joint at the middle of its range: all twelve limit rows carry
    -1e9 and their impulses are zero; finite, same tolerances."""
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    model = build_xbot_model().to(dev)
    st, tgt = _states(model, 64, dev)
    qpos = st.qpos.clone()
    qpos[:, 7:] = 0.5 * (model.dof_lower + model.dof_upper)
    want, ops = _mega_and_solve_match_plain(model, st.replace(qpos=qpos), tgt * 0.0 + qpos[:, 7:],
                                            dev)
    assert bool((ops[4][:, 48:] == -1e9).all())
    assert float(want[2][:, 48:].abs().max()) == 0.0


def test_env_step_runs_on_the_card(dev):
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
    from humanoid_gym_tpu_torch.envs import make_env

    cfg = XBotLCfg()
    cfg.sim.solver.solver_type = "mega"
    env = make_env(cfg, num_envs=64, device=dev, seed=0)
    state, obs, priv = env.reset_all()
    for _ in range(3):
        state, tr = env.step(state, torch.zeros((64, 12), device=dev))
    assert tr.obs.is_cuda and torch.isfinite(tr.obs).all() and torch.isfinite(tr.reward).all()



def test_terrain_mega_kernel_matches_plain(dev):
    """The terrain variant at 64 envs of `humanoid_ppo_terrain_robust` on a
    3 x 3 map (5 m border), placed by `init_state` and landed by 15 env
    steps: one policy step within the chip_smoke tolerances of the plain
    terrain step on the same IN2 rows, some active contact on a sloped
    cell, the terrain counter counts and the flat one does not, the
    patches kernel counts one launch; the same within those tolerances of
    the plain step on the plain chain's rows; a terrain step on a CUDA
    tensor never takes the flat kernel."""
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.physics import mega as MG

    def ov(cfg):
        cfg.terrain.num_rows, cfg.terrain.num_cols, cfg.terrain.border_size = 3, 3, 5.0
        cfg.terrain.max_init_terrain_level = 2
        cfg.sim.solver.solver_type = "mega"

    env, cfg = registry.make_env("humanoid_ppo_terrain_robust", num_envs=64, cfg_overrides=ov,
                                 device=dev, seed=0)
    state = env.init_state()
    zero = torch.zeros((64, 12), device=dev)
    for _ in range(15):
        state, _ = env.step(state, zero)
    st, tgt = state.phys, env.default_dof_pos.expand(64, 12)
    step = MG.make_mega_step_batched(env.model, 0.001, 10, env.p_gains, env.d_gains,
                                     env.torque_limits, iterations=8, terrain_map=env.terrain_map)
    args = (st.qpos, st.qvel, st.friction, st.base_mass_scale, st.contact_stiffness,
            st.contact_offset, st.kp_scale, st.kd_scale, st.contact_compliance, st.contact_lam)
    flat0, ter0 = MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches
    patches0 = MG.terrain_patches_launch.launches
    got = step(*args, st.slope_bias, tgt)
    assert (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches) == (flat0, ter0 + 1)
    assert MG.terrain_patches_launch.launches == patches0 + 1
    in2 = step.terrain_patches(st.qpos, st.slope_bias)
    for rows in (in2, step.terrain_patches.plain(st.qpos, st.slope_bias)):
        want = MG.mega_step_plain(env.model, 0.001, 10, env.p_gains, env.d_gains,
                                  env.torque_limits, 8, 1.0, *args, tgt, in2=rows,
                                  terrain=step.terrain)
        for g, w, tol in zip(got, want, (5e-4, 1e-2, 5e-3, 5e-2, 5e-3, 5e-4)):
            assert g.shape == w.shape and bool(torch.isfinite(g).all())
            assert float((g - w).abs().max()) <= tol
    slope = torch.hypot(in2[:, MG.IN2_GX:MG.IN2_GY] - st.slope_bias[:, :1],
                        in2[:, MG.IN2_GY:] - st.slope_bias[:, 1:])
    assert bool(((want[2][:, 2:48:3] > 0) & (slope > 1e-6)).any())
    with pytest.raises(ValueError):
        MG.mega_kernel_launch(MG.pack_inputs(*args, tgt), step.consts_dev, 0.001, 10, 8, 1.0,
                              packed2=in2[:, :100].contiguous(), terrain=step.terrain)


def _s_model_and_gains(dev):
    """The XBot-S model of `humanoid_s_ppo` on the card, its gains (kp x
    s^4, kd x s^4.5) and torque limit."""
    from humanoid_gym_tpu_torch.config.xbots import XBotSCfg
    from humanoid_gym_tpu_torch.envs.env import _match_gains
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    cfg = XBotSCfg()
    model = build_xbot_model(cfg.asset.file, mesh_dir=cfg.asset.mesh_dir).to(dev)
    kp = torch.as_tensor(_match_gains(model.dof_names, cfg.control.stiffness), device=dev)
    kd = torch.as_tensor(_match_gains(model.dof_names, cfg.control.damping), device=dev)
    return model, kp, kd, model.dof_effort * 0.85


@pytest.fixture(scope="module")
def landed_terrain():
    """4096 envs of `humanoid_ppo_terrain_robust` on a 3 x 3 map (5 m
    border), placed by `init_state` and landed by 15 env steps at zero
    actions, as `test_terrain_mega_kernel_matches_plain` lands its 64:
    (env, the landed physics state)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a and run only there")
    from humanoid_gym_tpu_torch import registry

    def ov(cfg):
        cfg.terrain.num_rows, cfg.terrain.num_cols, cfg.terrain.border_size = 3, 3, 5.0
        cfg.terrain.max_init_terrain_level = 2
        cfg.sim.solver.solver_type = "mega"

    dev = torch.device("cuda")
    env, _ = registry.make_env("humanoid_ppo_terrain_robust", num_envs=4096, cfg_overrides=ov,
                               device=dev, seed=0)
    state = env.init_state()
    zero = torch.zeros((4096, 12), device=dev)
    for _ in range(15):
        state, _ = env.step(state, zero)
    return env, state.phys


def _patches_step(env, robot, dev):
    """The terrain mega step of XBot-L (the env's own) or XBot-S on the
    env's map; its `terrain_patches` is the kernel's dispatcher."""
    from humanoid_gym_tpu_torch.physics import mega as MG

    if robot == "L":
        model, kp, kd, tl = env.model, env.p_gains, env.d_gains, env.torque_limits
    else:
        model, kp, kd, tl = _s_model_and_gains(dev)
    return MG.make_mega_step_batched(model, 0.001, 10, kp, kd, tl, iterations=8,
                                     terrain_map=env.terrain_map), model


@pytest.mark.parametrize("robot", ["L", "S"])
@pytest.mark.parametrize("n", [1, 37, 2048, 4096])
def test_terrain_patches_kernel_matches_plain_chain(dev, landed_terrain, robot, n):
    """The patches kernel (csrc/terrain_patches.cu) against the plain chain
    on the same landed states (XBot-S's chain on XBot-L's landed poses):
    one launch a call; taps and patch origin bit-identical at every point
    whose grid coordinate lies more than 1e-3 cells from a grid line, and
    at >= 99.9 % of all points (the chain's xy sums in cuBLAS's order, an
    ulp from the kernel's); slope rows within 1e-5; all finite; a qpos
    view with a row stride (as the env carries it) gives the same rows."""
    from humanoid_gym_tpu_torch.physics import mega as MG

    env, st = landed_terrain
    idx = torch.linspace(0, st.qpos.shape[0] - 1, n, device=dev).round().long()
    qpos, sb = st.qpos[idx].contiguous(), st.slope_bias[idx].contiguous()
    step, model = _patches_step(env, robot, dev)
    patches = step.terrain_patches
    n0 = MG.terrain_patches_launch.launches
    got = patches(qpos, sb)
    assert MG.terrain_patches_launch.launches == n0 + 1
    want = patches.plain(qpos, sb)
    assert got.shape == want.shape == (n, MG.IN2_ROWS) and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert float((got[:, MG.IN2_GX:] - want[:, MG.IN2_GX:]).abs().max()) <= 1e-5
    same = (got[:, :MG.IN2_GX] == want[:, :MG.IN2_GX]).reshape(n, 11, MG.N_POINTS).all(1)
    border, inv_h, gx_max, gy_max = step.terrain
    xy = MG.make_contact_xy(model)(qpos)
    g = torch.stack([torch.clamp((xy[..., 0] + border) * inv_h, 0.0, gx_max),
                     torch.clamp((xy[..., 1] + border) * inv_h, 0.0, gy_max)], -1)
    frac = g - torch.floor(g)
    far = torch.minimum(frac, 1.0 - frac).amin(-1) > 1e-3
    assert bool(same[far].all())
    assert float(same.float().mean()) >= 0.999
    wide = torch.cat([qpos, torch.zeros_like(qpos[:, :5])], 1)[:, :MG.NQ]
    assert wide.stride(0) == MG.NQ + 5
    assert torch.equal(patches(wide, sb), got)


def test_terrain_patches_of_two_robots_interleaved_on_one_stream(dev, landed_terrain):
    """XBot-L and XBot-S patches launches, each naming its own constants,
    queued L, S, L, S on one stream with no synchronisation between them:
    each output bit-equal to the same launch run alone, and the two robots'
    rows differ."""
    env, st = landed_terrain
    qpos, sb = st.qpos[:300].contiguous(), st.slope_bias[:300].contiguous()
    steps = {name: _patches_step(env, name, dev)[0] for name in ("L", "S")}
    alone = {}
    for name, step in steps.items():
        alone[name] = step.terrain_patches(qpos, sb)
        torch.cuda.synchronize()
    assert not torch.equal(alone["L"], alone["S"])
    outs = [(name, steps[name].terrain_patches(qpos, sb)) for name in ("L", "S", "L", "S")]
    torch.cuda.synchronize()
    for name, out in outs:
        assert torch.equal(out, alone[name]), name


def test_terrain_patches_launch_rejects_bad_inputs(dev, landed_terrain):
    """The patches wrapper raises before anything launches on a CPU grid,
    float64 qpos, a slope bias of the wrong shape or a strided column, or
    constants of the wrong length."""
    from humanoid_gym_tpu_torch.physics import mega as MG

    env, st = landed_terrain
    step, _ = _patches_step(env, "L", dev)
    grid = torch.zeros((8, 8), device=dev)
    qpos, sb = st.qpos[:4].contiguous(), st.slope_bias[:4].contiguous()
    n0 = MG.terrain_patches_launch.launches
    consts = step.consts_dev
    for args in ((qpos, sb, consts, grid.cpu()), (qpos.double(), sb, consts, grid),
                 (qpos, sb[:, :1], consts, grid), (qpos, sb.t().contiguous().t(), consts, grid),
                 (qpos, sb, consts[:-1], grid), (qpos, sb, consts, grid[:2])):
        with pytest.raises(ValueError):
            MG.terrain_patches_launch(*args, step.terrain)
    assert MG.terrain_patches_launch.launches == n0


@pytest.fixture(scope="module")
def smoke():
    import importlib.util

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  os.path.join(here, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reward_stage(smoke, config, dev):
    """(the reward stage, its config's rewards) of XBot-L's ("L") or XBot-S's
    ("S") reward set, or of every term with the termination term and no
    clip ("all", FK rows base-relative as the mega path passes them;
    "all_world", world-frame rows as the other solvers pass them)."""
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
    from humanoid_gym_tpu_torch.config.xbots import XBotSCfg
    from humanoid_gym_tpu_torch.envs import rewards as R

    cfg = XBotSCfg() if config == "S" else XBotLCfg()
    rcfg = smoke._all_reward_terms() if config.startswith("all") else cfg.rewards
    dflt = torch.as_tensor(list(cfg.init_state.default_joint_angles.values()), dtype=torch.float32,
                           device=dev)
    return R.make_rewards(rcfg, cfg.dt, dflt, (6, 12), feet_base=config != "all_world"), rcfg


@pytest.mark.parametrize("config", ["L", "S", "all", "all_world"])
@pytest.mark.parametrize("n", [4096, 2048, 1000, 1])
def test_rewards_kernel_matches_plain_chain(dev, smoke, config, n):
    """The rewards kernel (csrc/rewards.cu) against the plain chain on
    random states that reach every branch (chip_smoke.py `_reward_inputs`:
    rows not finite, each low_speed case, contacts, stance boundaries, the
    clearance band; every input a strided view as the env passes them), for
    XBot-L's and XBot-S's term sets (only-positive clip on) and for every
    term with a termination scale (clip off): reward and episode sums within
    1e-5 relative, the float feet state within 1e-6, last_contacts and the
    contact flags exact; one launch a call."""
    from humanoid_gym_tpu_torch.envs import rewards as R

    stage, rcfg = _reward_stage(smoke, config, dev)
    inp = smoke._reward_inputs(n, rcfg, len(stage.names), dev, seed=n + len(config),
                               feet_base=config != "all_world")
    n0 = R.rewards_launch.launches
    got = stage(inp)
    assert R.rewards_launch.launches == n0 + 1
    want = stage.plain(inp)
    reward, sums, feet, last_contacts, contact = smoke._reward_gaps(stage, inp, got, want)
    assert reward <= 1e-5 and sums <= 1e-5 and feet <= 1e-6, (reward, sums, feet)
    assert last_contacts and contact
    assert got.reward.is_contiguous() and got.episode_sums.shape == (n, len(stage.names))


def test_rewards_launch_rejects_bad_inputs(dev, smoke):
    """The rewards wrapper raises before anything launches on an input on
    the CPU, in float64, with a column stride, of the wrong width, or flags
    that are not bool."""
    from humanoid_gym_tpu_torch.envs import rewards as R

    stage, rcfg = _reward_stage(smoke, "L", dev)
    inp = smoke._reward_inputs(8, rcfg, len(stage.names), dev, seed=3)
    n0 = R.rewards_launch.launches
    for bad in (dict(actions=inp.actions.cpu()), dict(torques=inp.torques.double()),
                dict(commands=inp.commands.t().contiguous().t()),
                dict(feet_rows=inp.feet_rows[:, :13]), dict(finite=inp.finite.to(torch.uint8)),
                dict(episode_sums=inp.episode_sums[:, :3]),
                dict(contact_forces=inp.contact_forces.transpose(1, 2))):
        with pytest.raises(ValueError):
            R.rewards_launch(inp._replace(**bad), stage.default_dof_pos, stage.table)
    assert R.rewards_launch.launches == n0


@pytest.mark.parametrize("solver", ["mega", "apgd"])
def test_env_step_rewards_take_the_kernel(dev, solver):
    """An env step on the card launches the rewards kernel once; the same
    step from the same state and generator with the plain chain in its
    place gives the reward within 1e-5 relative, the episode sums at reset
    likewise, and the observations, done flags and carried feet state
    bit-equal (they read the kernel's flags and feet state)."""
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
    from humanoid_gym_tpu_torch.envs import make_env
    from humanoid_gym_tpu_torch.envs import rewards as R

    cfg = XBotLCfg()
    cfg.sim.solver.solver_type = solver
    env = make_env(cfg, num_envs=256, device=dev, seed=0)
    state, _, _ = env.reset_all()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for _ in range(5):
        state, _ = env.step(state, 0.3 * torch.randn((256, 12), device=dev, generator=gen))
    actions = 0.3 * torch.randn((256, 12), device=dev, generator=gen)
    g0 = env.gen.get_state()
    n0 = R.rewards_launch.launches
    s1, t1 = env.step(state, actions)
    assert R.rewards_launch.launches == n0 + 1
    kernel = env.rewards
    env.gen.set_state(g0)
    env.rewards = kernel.plain
    try:
        s2, t2 = env.step(state, actions)
    finally:
        env.rewards = kernel
    scale = t2.reward.abs().max() + 1e-6
    assert float((t1.reward - t2.reward).abs().max()) <= 1e-5 * float(scale)
    assert float((t1.ep_term_sums - t2.ep_term_sums).abs().max()) <= 1e-5 * float(
        t2.ep_term_sums.abs().max() + 1e-6)
    for a, b in ((t1.obs, t2.obs), (t1.privileged_obs, t2.privileged_obs), (t1.done, t2.done),
                 (s1.feet_air_time, s2.feet_air_time), (s1.last_contacts, s2.last_contacts),
                 (s1.feet_height, s2.feet_height), (s1.last_feet_z, s2.last_feet_z)):
        assert torch.equal(a, b)


def test_two_models_interleaved_on_one_stream(dev):
    """XBot-L and XBot-S launches of the flat mega kernel, each naming its
    own constants: S within the chip_smoke tolerances of the plain S step;
    then L, S, L, S queued on one stream with no synchronisation between
    them, each output bit-equal to the same launch run alone."""
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    n = 300
    lm = build_xbot_model().to(dev)
    sm, skp, skd, stl = _s_model_and_gains(dev)
    lkp, lkd, ltl = _gains(lm, dev)
    runs = {}
    for name, model, kp, kd, tl, z in (("L", lm, lkp, lkd, ltl, 0.9), ("S", sm, skp, skd, stl, 0.65)):
        st, tgt = _states(model, n, dev)
        st = st.replace(qpos=torch.cat([st.qpos[:, :2], torch.full_like(st.qpos[:, 2:3], z),
                                        st.qpos[:, 3:]], dim=1))
        step = MG.make_mega_step_batched(model, 0.001, 10, kp, kd, tl, iterations=8)
        args = (st.qpos, st.qvel, st.friction, st.base_mass_scale, st.contact_stiffness,
                st.contact_offset, st.kp_scale, st.kd_scale, st.contact_compliance, st.contact_lam,
                tgt)
        packed = MG.pack_inputs(*args)
        alone = MG.mega_kernel_launch(packed, step.consts_dev, 0.001, 10, 8, 1.0)
        torch.cuda.synchronize()
        want = MG.mega_step_plain(model, 0.001, 10, kp, kd, tl, 8, 1.0, *args)
        for g, w, tol in zip(MG.unpack_outputs(alone), want, (5e-4, 1e-2, 5e-3, 5e-2, 5e-3, 5e-4)):
            assert bool(torch.isfinite(g).all()) and float((g - w).abs().max()) <= tol, name
        runs[name] = (packed, step.consts_dev, alone)
    assert float((runs["L"][1] - runs["S"][1]).abs().max()) > 1.0
    outs = [(name, MG.mega_kernel_launch(runs[name][0], runs[name][1], 0.001, 10, 8, 1.0))
            for name in ("L", "S", "L", "S")]
    torch.cuda.synchronize()
    for name, out in outs:
        assert torch.equal(out, runs[name][2]), name


def test_mega_kernel_launch_rejects_bad_constants(dev):
    """The constants of a launch must be a contiguous float32 (541,) tensor
    on the device of the inputs: a NumPy blob, a CPU tensor, float64, the
    wrong length or a strided view raise before anything launches."""
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    model = build_xbot_model().to(dev)
    kp, kd, tl = _gains(model, dev)
    consts = MG.pack_model_constants(model, kp, kd, tl)
    packed = torch.zeros((4, MG.IN_ROWS), device=dev)
    good = MG.model_constants_tensor(consts, dev)
    n0 = MG.mega_kernel_launch.launches
    for bad in (consts, torch.from_numpy(consts), good.double(), good[:-1],
                torch.stack([good, good], dim=1)[:, 0]):
        with pytest.raises(ValueError, match="constants"):
            MG.mega_kernel_launch(packed, bad, 0.001, 10, 8, 1.0)
    assert MG.mega_kernel_launch.launches == n0
    MG.mega_kernel_launch(packed, good, 0.001, 1, 0, 1.0)
    torch.cuda.synchronize()
    assert MG.mega_kernel_launch.launches == n0 + 1

def _dense_operands(model, n, dev, lift=0.0, mid_range=False):
    """Operands of the two dense solver kernels at n states one policy step
    into contact: (fused operands, apgd operands). `lift` raises the robots
    (no contact row stays active), `mid_range` puts every joint at the middle
    of its range (no limit row stays active)."""
    from humanoid_gym_tpu_torch.physics import step as ST
    from humanoid_gym_tpu_torch.physics.contact import delassus_operands
    from humanoid_gym_tpu_torch.physics.dynamics import solve_mtilde
    from humanoid_gym_tpu_torch.physics.mega import flat_height_fn

    kp, kd, tl = _gains(model, dev)
    st, tgt = _states(model, n, dev)
    st = ST.make_physics_step(model, 0.001, 10, kp, kd, tl, 8, solver="apgd")(st, tgt)
    qpos = st.qpos.clone()
    qpos[:, 2] += lift
    if mid_range:
        qpos[:, 7:] = 0.5 * (model.dof_lower + model.dof_upper)
    st = st.replace(qpos=qpos)
    _, _, fused = ST.fused_operands(model, 0.001, st, tgt, kp, kd, tl)
    _, dyn, _, rhs = ST.substep_dynamics(model, 0.001, st, tgt, kp, kd, tl)
    v_free = st.qvel + solve_mtilde(dyn.Mtilde_chol, rhs)
    setup, sign, lb, _, A, u0, bound = delassus_operands(
        model, dyn, st.qpos, v_free, flat_height_fn, 0.001, contact_offset=st.contact_offset,
        baumgarte=0.2 * st.contact_stiffness, compliance=st.contact_compliance)
    apgd = [t.contiguous() for t in (A, u0, setup.lo_bound, sign, lb, st.friction, bound,
                                     st.contact_lam)]
    return fused, apgd


def _dense_kernels_match_plain(fused, apgd):
    """Both dense kernels within the chip_smoke tolerances of their plain
    versions (lam 2e-3, qvel 5e-4) at 8 iterations, finite; the APGD kernel
    with the caller's step bound, with `step_bound=None` (-> ||A'||_inf) and
    with no warm start; the counters count. Returns the plain fused outputs."""
    from humanoid_gym_tpu_torch.physics import solve as SV

    n = fused[0].shape[0]
    n3, n4 = SV.fused_dense_solve.launches, SV.apgd_solve_kernel.launches
    q, lam = SV.fused_dense_solve(*fused, iterations=8)
    q_p, lam_p = SV.fused_dense_solve_plain(*fused, iterations=8)
    assert q.shape == (n, 18) and lam.shape == (n, 60)
    assert bool(torch.isfinite(q).all() and torch.isfinite(lam).all())
    assert float((q - q_p).abs().max()) <= 5e-4
    assert float((lam - lam_p).abs().max()) <= 2e-3
    for bound in (apgd[6], None):
        ops = apgd[:6] + [bound, apgd[7]]
        lam4 = SV.apgd_solve_kernel(*ops, iterations=8)
        lam4_p = SV.apgd_solve_kernel_plain(*ops, iterations=8)
        assert lam4.shape == (n, 60) and bool(torch.isfinite(lam4).all())
        assert float((lam4 - lam4_p).abs().max()) <= 2e-3
    cold = SV.apgd_solve_kernel(*apgd[:7], None, iterations=8)
    assert float((cold - SV.apgd_solve_kernel_plain(*apgd[:7], None, iterations=8)).abs().max()) <= 2e-3
    assert SV.fused_dense_solve.launches == n3 + 1 and SV.apgd_solve_kernel.launches == n4 + 3
    return q_p, lam_p


@pytest.mark.parametrize("n", [300, 37, 1, 1621])
def test_dense_solver_kernels_match_plain(dev, n):
    """300 envs; 37 (not a multiple of the block's 4 envs, and fewer envs
    than the APGD kernel has persistent warps); 1; and 1621 = 1584 + 37, more
    than one round of the APGD kernel's persistent warps on an H100 (132 SMs x
    3 blocks x 4 warps) with a ragged end."""
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    model = build_xbot_model().to(dev)
    fused, apgd = _dense_operands(model, n, dev)
    _, lam_p = _dense_kernels_match_plain(fused, apgd)
    if n >= 37:
        assert float(lam_p.abs().max()) > 0.05


def test_dense_solver_kernels_with_no_active_contact_row(dev):
    """Robots lifted a metre above the ground: every contact row carries the
    inactive sentinel -1e9, the impulses stay zero, and the dense kernels
    stay finite and inside the same tolerances."""
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    model = build_xbot_model().to(dev)
    fused, apgd = _dense_operands(model, 64, dev, lift=1.0)
    assert bool((fused[4] == -1e9).all() and (apgd[2] == -1e9).all())
    _, lam_p = _dense_kernels_match_plain(fused, apgd)
    assert float(lam_p[:, :48].abs().max()) == 0.0


def test_dense_solver_kernels_with_all_limit_rows_inactive(dev):
    """Every joint at the middle of its range: all twelve limit rows carry
    -1e9 and their impulses are zero; finite, same tolerances."""
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    model = build_xbot_model().to(dev)
    fused, apgd = _dense_operands(model, 64, dev, mid_range=True)
    assert bool((fused[6] == -1e9).all() and (apgd[4] == -1e9).all())
    _, lam_p = _dense_kernels_match_plain(fused, apgd)
    assert float(lam_p[:, 48:].abs().max()) == 0.0


def test_dense_solver_wrappers_reject_bad_operands(dev):
    """A CUDA tensor launches the kernel or raises: wrong dtype, layout or
    device is an error, never a fall back to the plain version."""
    from humanoid_gym_tpu_torch.physics import solve as SV
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    model = build_xbot_model().to(dev)
    fused, apgd = _dense_operands(model, 8, dev)
    bad = list(fused)
    bad[1] = fused[1].transpose(1, 2)  # J^T: not (N, nrow, nv)
    with pytest.raises(ValueError):
        SV.fused_dense_solve(*bad, iterations=8)
    bad = list(apgd)
    bad[1] = apgd[1].double()
    with pytest.raises(ValueError):
        SV.apgd_solve_kernel(*bad, iterations=8)
    bad = list(apgd)
    bad[5] = apgd[5].cpu()
    with pytest.raises(ValueError):
        SV.apgd_solve_kernel(*bad, iterations=8)
    # the kernels are compiled for 60 rows (16 contact points + 12 limit rows):
    # 59 rows (one limit row fewer) is a shape they no longer take
    A, u0, lo, sign, lb, mu, bound, lam = apgd
    with pytest.raises(ValueError, match="60 rows"):
        SV.apgd_solve_kernel(A[:, :59, :59].contiguous(), u0[:, :59].contiguous(), lo,
                             sign[:, :11].contiguous(), lb[:, :11].contiguous(), mu, bound,
                             lam[:, :59].contiguous(), iterations=8)
    bad = list(fused)
    bad[1] = fused[1][:, :59].contiguous()
    bad[5], bad[6] = fused[5][:, :11].contiguous(), fused[6][:, :11].contiguous()
    bad[9] = fused[9][:, :59].contiguous()
    with pytest.raises(ValueError, match="60 rows"):
        SV.fused_dense_solve(*bad, iterations=8)
    # a matrix that does not start on a 16-byte boundary (the bulk copy's rule)
    shifted = torch.empty(A.numel() + 1, device=A.device)[1:].view_as(A).copy_(A)
    with pytest.raises(ValueError, match="16-byte"):
        SV.apgd_solve_kernel(shifted, *apgd[1:], iterations=8)


@pytest.mark.parametrize("solver, counter", [("fused_pallas", "fused_dense_solve"),
                                             ("apgd_pallas", "apgd_solve_kernel")])
def test_env_step_substep_solvers_on_the_card(dev, solver, counter):
    """An env step with a per-substep solver launches its kernel once per
    substep (10 per step) and never the mega kernel."""
    from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg
    from humanoid_gym_tpu_torch.envs import make_env
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.physics import solve as SV

    cfg = XBotLCfg()
    cfg.sim.solver.solver_type = solver
    env = make_env(cfg, num_envs=64, device=dev, seed=0)
    state, obs, priv = env.reset_all()
    n0, m0 = getattr(SV, counter).launches, MG.mega_kernel_launch.launches
    for _ in range(2):
        state, tr = env.step(state, torch.zeros((64, 12), device=dev))
    assert getattr(SV, counter).launches == n0 + 20
    assert MG.mega_kernel_launch.launches == m0
    assert tr.obs.is_cuda and torch.isfinite(tr.obs).all() and torch.isfinite(tr.reward).all()


@pytest.mark.parametrize("task", ["humanoid_ppo", "humanoid_ppo_terrain_robust"])
def test_env_step_does_not_synchronise_the_host(dev, task):
    """Three env steps (solver mega, 256 envs) under
    `set_sync_debug_mode("error")`, with a resample every step and half the
    envs resetting in the first: no host synchronisation raises."""
    from humanoid_gym_tpu_torch import registry

    def ov(c):
        c.sim.solver.solver_type = "mega"
        c.commands.resampling_time = c.dt

    env, _ = registry.make_env(task, num_envs=256, cfg_overrides=ov, device=dev, seed=0)
    zero = torch.zeros((256, 12), device=dev)
    state, _ = env.step(env.init_state(), zero)
    half = (torch.arange(256, device=dev) % 2 == 0).to(torch.int32)
    state = state.replace(episode_length=half * env.max_episode_length)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, first = env.step(state, zero)
        for _ in range(2):
            state, tr = env.step(state, zero)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(first.done.sum()) >= 128
    assert torch.isfinite(tr.obs).all()


@pytest.mark.parametrize("solver", ["apgd", "mega"])
def test_captured_entry_replays_equal_eager_steps(dev, solver):
    """graft_entry_torch's step captured as one CUDA graph: three replays
    fed forward are bit-equal to three eager steps from the same state and
    generator state; the mega kernel's wrapper is called while capturing
    only."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import graft_entry_torch as GE
    from humanoid_gym_tpu_torch.physics import mega as MG

    fn, (net, state0, obs0, priv0) = GE.entry(device=dev, solver=solver)
    g0 = fn.env.gen.get_state()
    graph = GE.CapturedStep(fn.step, net, state0, obs0, priv0, fn.env.gen)

    def roll(step):
        fn.env.gen.set_state(g0)
        st, o, p, seen = state0, obs0, priv0, []
        for _ in range(3):
            st, out = step(st, o, p)
            o, p = out[0], out[1]
            seen += [x.clone() for x in (*out, st.phys.qpos)]
        return seen

    want = roll(lambda s, o, p: fn.step(net, s, o, p))
    n0 = MG.mega_kernel_launch.launches
    got = roll(graph)
    assert MG.mega_kernel_launch.launches == n0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("task", ["humanoid_ppo", "humanoid_ppo_terrain_robust",
                                  "humanoid_joint_ppo", "humanoid_ppo_lstm"])
def test_captured_train_iter_equals_eager(dev, task):
    """The training iteration captured as one CUDA graph against the eager
    one at 16 envs, T = 8, solver mega (chip_smoke.py phase 24's comparison
    at a small size): 3 iterations a side from one snapshot, bit-equal, the
    same mega (and on terrain patches) launches on each side, counted from
    the replays. The recurrent policy's memory is part of the train state
    compared, so it carries from replay to replay as from eager iteration to
    eager iteration."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    r = smoke._captured_against_eager(task, dev, n_envs=16, horizon=8, iters=3)
    # capture.LAUNCH_COUNTERS: flat, terrain, three solvers, terrain patches, rewards
    want = [0] * 7
    want[1 if "terrain" in task else 0] = want[6] = (2 if "joint" in task else 1) * 8 * 3
    if "terrain" in task:
        want[5] = want[1]
    assert r["launches_eager"] == r["launches_replayed"] == want
    assert r["worst_rel"] == 0.0, r["where"]


def _snapshot_parts(task, dev, n_envs=16, horizon=8):
    """(env, net, train state, ppo config, generator, inputs) of `task` at
    n_envs envs, T = horizon, solver mega, and a function that puts the
    train state, the generators and a copy of the inputs back as they
    were here."""
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.capture import clone_tree, train_state_tensors
    from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, init_train_state

    def mega(c):
        c.sim.solver.solver_type = "mega"

    env, cfg = registry.make_env(task, num_envs=n_envs, cfg_overrides=mega, device=dev, seed=0)
    tcfg = registry.get_task(task).make_train_cfg()
    net = actor_critic_from_cfg(cfg.env, tcfg.policy, seed=0).to(dev)
    pc = PPOConfig.from_cfg(tcfg.algorithm)
    pc.num_steps_per_env = horizon
    ts = init_train_state(net, pc.learning_rate)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    gens = [gen, *env.generators()]
    inputs = clone_tree(env.reset_all())
    snap = ([t.detach().clone() for t in train_state_tensors(ts)], [g.get_state() for g in gens])

    def restore():
        with torch.no_grad():
            for t, v in zip(train_state_tensors(ts), snap[0]):
                t.copy_(v)
        ts.iteration = 0
        for g, v in zip(gens, snap[1]):
            g.set_state(v)
        return clone_tree(inputs)

    return env, net, ts, pc, gen, restore


@pytest.mark.parametrize("task", ["humanoid_ppo", "humanoid_joint_deploy"])
def test_stamped_capture_replays_equal_unstamped(dev, task):
    """The training iteration captured with the stage stamps (a tracer
    active during the capture) against one captured without, from one
    snapshot at 16 envs, T = 8, solver mega: 3 calls a side give the same
    train state, env state, obs and metrics to the bit; the stamped graph
    holds 2 stamps a stage (the terrain patches inside the physics on the
    deploy task), and each replay's stamps never fall and rise from the
    root's entry to its exit."""
    from humanoid_gym_tpu_torch.algo.capture import (
        CapturedTrainIter,
        tensor_leaves,
        train_state_tensors,
    )
    from humanoid_gym_tpu_torch.utils import tracing

    env, net, ts, pc, gen, restore = _snapshot_parts(task, dev)

    def side(tracer):
        inputs = restore()
        it = CapturedTrainIter(env, net, pc, 16)
        outs, stamps = [], []
        for _ in range(3):
            with tracing.activated(tracer):
                _, *inputs, metrics = it(ts, *inputs, gen)
            torch.cuda.synchronize()
            outs += [t.detach().clone() for t in train_state_tensors(ts) + tensor_leaves(inputs)]
            outs += [metrics[k] for k in sorted(metrics)]
            if tracer is not None:
                stamps.append(tracer.stamps().cpu().numpy())
        it.reset()
        return outs, stamps

    want, _ = side(None)
    tracer = tracing.StageTracer(dev)
    got, stamps = side(tracer)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    names = [r.name for r in tracer.stages]
    assert names[0] == tracing.ROOT and names[-1] == "iter.inputs"
    assert names.count("env.physics") == 8 * (2 if "joint" in task else 1)
    assert names.count("env.physics.terrain") == (16 if "joint" in task else 0)
    assert tracer.slots == 2 * len(names) and len(stamps) == 3
    root = tracer.stages[0]
    for s in stamps:
        assert len(s) == tracer.slots and (np.diff(s) >= 0).all()
        assert s[root.exit] > s[root.enter]
    assert not (stamps[0] == stamps[1]).all()  # each replay writes its own
    offset, bracket = tracer.clock
    assert 0 < bracket < 5_000_000


def test_traced_learn_and_its_profile_on_the_card(dev, tmp_path, monkeypatch):
    """`learn(3)` at 16 envs, T = 8 with HGT_PROFILE_DIR: tracing is on, each
    fetched iteration's stamps come back through the runner's fetch, the
    gaps between iterations are charged to runner spans, and the Chrome
    trace of the second iteration holds the `stages` track, placed by the
    `hgt_stamp` kernels' own times."""
    import json

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner

    def mega(c):
        c.sim.solver.solver_type = "mega"

    monkeypatch.setenv("HGT_WANDB", "0")
    monkeypatch.setenv("HGT_PROFILE_DIR", str(tmp_path / "prof"))
    env, _ = registry.make_env("humanoid_ppo", num_envs=16, cfg_overrides=mega, device=dev, seed=0)
    tcfg = registry.get_task("humanoid_ppo").make_train_cfg()
    tcfg.runner.num_steps_per_env = 8
    runner = OnPolicyRunner(env, tcfg, log_dir=None, seed=0)
    runner.learn(3)
    tracer = runner.tracer
    assert tracer is not None and len(tracer.iterations) == 3
    assert all(0 < i.covered_ns <= i.end - i.start for i in tracer.iterations)
    assert [name for name, _ in tracer.gaps()] and all(
        ns >= 0 for ns, _ in tracer.gaps())
    events = json.load(open(tmp_path / "prof" / "trace_iter1.json"))["traceEvents"]
    stamps = [e for e in events if e.get("cat") == "kernel" and e["name"].startswith("hgt_stamp")]
    assert len(stamps) == tracer.slots
    stages = [e for e in events if e.get("cat") == "stage"]
    assert [e["name"] for e in stages] == [r.name for r in tracer.stages]
    assert stages[0]["ts"] == min(e["ts"] for e in stamps)


def test_mega_kernels_keep_their_registers_and_spills(dev, tmp_path):
    """B1 and B1t (csrc/mega.cu, beside which the stamp kernel builds as a
    library of its own) compile to the registers, stack frame and spill
    stores that PERF.md's kernel table records (chip_smoke.py's ptxas
    summary of a fresh cubin)."""
    import importlib.util

    from humanoid_gym_tpu_torch.physics.mega_sass import _cubin

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    proc = _cubin(os.path.join(here, "humanoid_gym_tpu_torch", "csrc"),
                  str(tmp_path / "mega.cubin"))
    log, _ = proc.communicate()
    assert proc.returncode == 0, log
    lines = {ln.split(":")[0]: ln for ln in smoke._ptxas_summary(log).split(" | ")}
    assert lines["hgt_mega_kernel<false>"].startswith("hgt_mega_kernel<false>: Used 64 registers")
    assert "; 112 bytes stack frame, 108 bytes spill stores" in lines["hgt_mega_kernel<false>"]
    assert lines["hgt_mega_kernel<true>"].startswith("hgt_mega_kernel<true>: Used 64 registers")
    assert "; 128 bytes stack frame, 148 bytes spill stores" in lines["hgt_mega_kernel<true>"]


def test_rewards_kernel_keeps_its_registers_and_spills(dev, tmp_path, smoke):
    """The rewards kernel (csrc/rewards.cu, a library of its own) compiles
    to the registers, stack frame and spill stores that PERF.md's table of
    the port's own kernels records (row P2)."""
    import subprocess

    from humanoid_gym_tpu_torch.physics import cuda_build as CB

    cmd = [CB._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
           "-Xptxas", "-v", "-o", str(tmp_path / "rewards.cubin"),
           os.path.join(CB.CSRC_DIR, "rewards.cu")]
    run = subprocess.run(cmd, capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr
    (line,) = smoke._ptxas_summary(run.stdout + run.stderr).split(" | ")
    assert line.startswith("hgt_rewards_kernel: Used 64 registers"), line
    assert "; 0 bytes stack frame, 0 bytes spill stores" in line, line
