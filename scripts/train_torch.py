"""Train a task with the PyTorch/CUDA port (the counterpart of scripts/train.py).

Usage:
    python scripts/train_torch.py --task humanoid_ppo --num_envs 4096 \
        --max_iterations 3001 --run_name v1
    torchrun --standalone --nproc_per_node=K scripts/train_torch.py --task humanoid_ppo \
        --num_envs 16384 --backend nccl      # K ranks, num_envs / K envs each

Under a launcher (WORLD_SIZE set) each process is one rank of an
env-sharded run on `cuda:LOCAL_RANK` (or the CPU with `--device cpu` and
`--backend gloo`); `--num_envs` is the global count and the world size must
divide it. Without the launcher's variables it is a single process.

Runs on the CUDA card unless `--device cpu` is given, and fails if there is
no card. The contact solver is `mega` on the card and `apgd` on the CPU;
HGT_SOLVER overrides it with any of mega / apgd / pgs / apgd_pallas /
fused_pallas (the last two run the CUDA solver kernels on the card and
their plain versions on the CPU). The solver that was asked for runs or
the script fails: there is no fallback to another one.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def train(args):
    from humanoid_gym_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    group = None
    if "WORLD_SIZE" in os.environ:
        from humanoid_gym_tpu_torch.parallel import make_env_group

        backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
        group = make_env_group(backend, device=args.device)
        device = group.device
    try:
        _train(args, device, group)
    finally:
        if group is not None:
            group.close()


def _train(args, device, group):
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner
    from humanoid_gym_tpu_torch.utils.helpers import (
        class_to_dict,
        get_load_path,
        resolve_log_dir,
        update_cfg_from_args,
    )

    spec = registry.get_task(args.task)
    env_cfg = spec.make_env_cfg()
    train_cfg = spec.make_train_cfg()
    update_cfg_from_args(env_cfg, train_cfg, args)

    log_dir = resolve_log_dir(train_cfg, root=args.log_root)
    resume_path = None
    if train_cfg.runner.resume:
        # resolve before the (expensive) env build so a missing run fails fast
        resume_path = get_load_path(
            os.path.dirname(log_dir),
            load_run=train_cfg.runner.load_run,
            checkpoint=train_cfg.runner.checkpoint,
        )
        if group is None or group.is_main:
            print(f"Will resume from: {resume_path}")

    default_solver = "apgd" if device.type == "cpu" else "mega"

    def overrides(c):
        update_cfg_from_args(c, None, args)
        c.sim.solver.solver_type = os.environ.get("HGT_SOLVER", default_solver)

    overrides(env_cfg)  # so config.json records the solver that runs
    env, _ = registry.make_env(
        args.task, num_envs=env_cfg.env.num_envs, cfg_overrides=overrides, device=device,
        seed=train_cfg.seed, group=group,
    )
    runner = OnPolicyRunner(env, train_cfg, log_dir=log_dir)
    if runner.log_dir:
        # reproducibility: dump the resolved config tree next to the ckpts
        with open(os.path.join(runner.log_dir, "config.json"), "w") as f:
            json.dump(
                {"env": class_to_dict(env_cfg), "train": class_to_dict(train_cfg)},
                f, indent=1, default=str,
            )
    if resume_path is not None:
        # exact resume: restore Adam moments/count alongside params
        runner.load(resume_path, load_optimizer=True)
    runner.learn(
        num_learning_iterations=train_cfg.runner.max_iterations,
        init_at_random_ep_len=True,
    )


if __name__ == "__main__":
    from humanoid_gym_tpu_torch.utils.helpers import get_args

    train(get_args())
