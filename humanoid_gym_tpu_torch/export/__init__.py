"""Deployment artifacts of a trained actor: `policy.npz`, `policy.bin` and
`policy_jit.pt` in the JAX package's formats, and their loader. The JAX
package's MuJoCo sim2sim and native evaluator read them as they are."""

from .policy_export import NumpyPolicy, export_policy, load_policy

__all__ = ["NumpyPolicy", "export_policy", "load_policy"]
