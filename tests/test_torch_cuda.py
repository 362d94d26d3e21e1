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


def test_mega_and_solve_kernels_match_plain(dev):
    """256 envs, one policy step: the kernel within the chip_smoke
    tolerances of the plain version (qpos 5e-4, qvel 1e-2, tau 5e-2), and
    the stand-alone solve within qvel 5e-4, lam 2e-3; counters count."""
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.physics import solve as SV
    from humanoid_gym_tpu_torch.physics.model import build_xbot_model

    model = build_xbot_model().to(dev)
    kp = torch.tensor([200, 200, 350, 350, 15, 15] * 2, dtype=torch.float32, device=dev)
    kd = torch.full((12,), 10.0, device=dev)
    tl = model.dof_effort * 0.85
    st, tgt = _states(model, 256, dev)
    args = (st.qpos, st.qvel, st.friction, st.base_mass_scale, st.contact_stiffness,
            st.contact_offset, st.kp_scale, st.kd_scale, st.contact_compliance, st.contact_lam, tgt)
    step = MG.make_mega_step_batched(model, 0.001, 10, kp, kd, tl, iterations=8)
    n0 = MG.mega_kernel_launch.launches
    got = step(*args)
    assert MG.mega_kernel_launch.launches == n0 + 1
    want = MG.mega_step_plain(model, 0.001, 10, kp, kd, tl, 8, 1.0, *args)
    for g, w, tol in zip(got, want, (5e-4, 1e-2, 5e-3, 5e-2, 5e-3, 5e-4)):
        assert float((g - w).abs().max()) <= tol
    ms = torch.ones((256, 13), device=dev)
    _, ops = MG.solve_operands(model, 0.001, st.qpos, st.qvel, tgt, kp, kd, tl, ms, st.friction,
                               st.contact_stiffness, st.contact_offset, st.contact_compliance,
                               st.contact_lam)
    q, lam = SV.fused_solve(*ops, iterations=8)
    q_p, lam_p = SV.fused_solve_plain(*ops, iterations=8)
    assert float((q - q_p).abs().max()) <= 5e-4
    assert float((lam - lam_p).abs().max()) <= 2e-3


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
