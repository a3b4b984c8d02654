"""lqg_tpu: an accelerator-native LQG control & inverse optimal control framework.

A from-scratch, batch-first JAX implementation of the capabilities of the reference
``lqg`` library (inverse optimal control for continuous psychophysics,
Straub & Rothkopf 2022): finite-horizon LQG forward models (Riccati/LQR
backward recursion, Kalman-filter forward pass, closed-loop rollout with
subjective internal models, temporal delays, point-mass/hand dynamics), the
marginalized trajectory likelihood, and native Bayesian/MLE parameter
inference (NUTS, SVI, hierarchical shared-parameter models).

Public surface matches the reference top level (``lqg/__init__.py:5-7``):
``LQG, Actor, Dynamics, System, LQGSpec, xcorr`` plus the ``infer`` package.
"""

__version__ = "0.1.0"

from lqg_tpu.spec import LQGSpec
from lqg_tpu.system import LQG, Actor, Dynamics, System, LQGDistribution
from lqg_tpu.ccg import xcorr

__all__ = [
    "LQG",
    "Actor",
    "Dynamics",
    "System",
    "LQGSpec",
    "LQGDistribution",
    "xcorr",
    "__version__",
]
