"""Training runner: orchestration, metrics, checkpointing."""

from .on_policy_runner import OnPolicyRunner

__all__ = ["OnPolicyRunner"]
