"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips, with the reason, where torch sees no CUDA
card (the CPU tier). On the GPU machine run them with
`python -m pytest tests/test_torch_cuda.py -q`; chip_smoke.py makes the
same checks at the main path's full width.
"""

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
    cell, the terrain counter counts and the flat one does not; a terrain
    step on a CUDA tensor never takes the flat kernel."""
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
    got = step(*args, st.slope_bias, tgt)
    assert (MG.mega_kernel_launch.launches, MG.mega_kernel_launch.terrain_launches) == (flat0, ter0 + 1)
    in2 = step.terrain_patches(st.qpos, st.slope_bias)
    want = MG.mega_step_plain(env.model, 0.001, 10, env.p_gains, env.d_gains, env.torque_limits, 8,
                              1.0, *args, tgt, in2=in2, terrain=step.terrain)
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
