"""The training-throughput benchmark of humanoid_gym_tpu_torch (see run.py)."""
