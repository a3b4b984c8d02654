"""The System layer: closed-loop simulation and the marginalized likelihood.

Mirrors the public surface of reference ``lqg/system.py`` (``System``, ``LQG``,
``Actor``, ``Dynamics``, dims API, ``simulate`` / ``conditional_*`` /
``log_likelihood`` / ``belief_tracking_distribution`` and the distribution
adapter) on top of the batched recursions in :mod:`lqg_tpu.ops`.

Key architectural differences from the reference:

* ``simulate`` runs ONE scan with all trials batched into the leading axis of
  the state matrices (the reference vmaps a per-trial scan,
  ``system.py:84-135``); each scan step is a set of ``(n, k) @ (k, m)``
  matmuls over the whole trial batch.
* The likelihood hoists gains and the data-free covariance recursion out of
  the trial batch entirely (the reference recomputes them per trial under
  vmap, ``system.py:157-161``); see :mod:`lqg_tpu.ops.gaussian`.
* Specs may be *stationary* (no time axis); the reference's stacked layout is
  also accepted everywhere.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax, random

from lqg_tpu.backend import kernel_route, require_kernel_route
from lqg_tpu.spec import LQGSpec
from lqg_tpu.ops import riccati, kalman, gaussian
from lqg_tpu.ops.linalg import mT
from lqg_tpu.utils import time_stack_spec, stationary_spec
from lqg_tpu.infer.dists import GaussianSequence, MultivariateNormal


def _stacked(spec: LQGSpec) -> bool:
    return spec.A.ndim > spec.Qf.ndim


_FORCE_SCAN = False


class force_scan_dispatch:
    """Context manager: make ``method="auto"`` resolve to the XLA scan paths.

    The fused Pallas kernels expose reverse-mode gradients only (hand-derived
    ``custom_vjp`` adjoints); callers that need forward-mode differentiation
    - e.g. the exact-Hessian Laplace preconditioner's forward-over-reverse
    ``jacfwd(grad(potential))``, :func:`lqg_tpu.infer.svi.laplace_guide` -
    wrap the trace in this context so dispatch stays on plain XLA scans,
    which JAX can JVP through.  Also convenient for kernel-vs-scan A/B runs.
    """

    def __enter__(self):
        global _FORCE_SCAN
        self._prev = _FORCE_SCAN
        _FORCE_SCAN = True
        return self

    def __exit__(self, *exc):
        global _FORCE_SCAN
        _FORCE_SCAN = self._prev
        return False


def _tl(x: jnp.ndarray, spec: LQGSpec) -> jnp.ndarray:
    """Time-leading broadcastable view of a per-step spec field."""
    return jnp.moveaxis(x, -3, 0) if _stacked(spec) else x[None]


class System:
    """An actor (subjective internal model) controlling true dynamics.

    Gains are computed from ``actor``; trajectories evolve under ``dynamics``
    (reference ``lqg/system.py:12-15``).
    """

    def __init__(self, actor: LQGSpec, dynamics: LQGSpec,
                 horizon: Optional[int] = None, control_noise=None):
        self.actor = actor
        self.dynamics = dynamics
        # control-multiplicative (signal-dependent) noise channels (k, n, m):
        # extra dynamics noise sum_i eps_i C_i u (Todorov 2005); changes the
        # Riccati pass and the rollout, see riccati.backward_multiplicative
        self.control_noise = control_noise
        if horizon is None:
            if not _stacked(dynamics):
                raise ValueError("stationary specs require an explicit horizon")
            horizon = dynamics.A.shape[-3]
        self.horizon = horizon

    # --- dims API (reference system.py:17-60) ---
    @property
    def T(self) -> int:
        return self.horizon

    @property
    def xdim(self) -> int:
        return self.dynamics.A.shape[-1]

    @property
    def ydim(self) -> int:
        return self.dynamics.F.shape[-2]

    @property
    def bdim(self) -> int:
        return self.actor.A.shape[-1]

    @property
    def udim(self) -> int:
        return self.dynamics.B.shape[-1]

    # --- gains ---
    def _default_Sigma0(self) -> jnp.ndarray:
        V0 = self.actor.V[0] if _stacked(self.actor) else self.actor.V
        with jax.default_matmul_precision("highest"):
            return V0 @ mT(V0)

    def _fused_ok(self) -> bool:
        """Can the fused Pallas gains kernel take this actor spec?

        Requires: a backend with a compiled kernel route, unbatched
        stationary float32 spec within the kernel's dim limits, no
        control-multiplicative noise, and concretely zero affine/cross cost
        terms (the kernel ignores ``q, r, P``).
        """
        from lqg_tpu.ops.pallas.gains import fused_gains_available

        if _FORCE_SCAN or not kernel_route():
            return False

        a = self.actor
        if (self.control_noise is not None
                or a.A.ndim != 2 or a.A.dtype != jnp.float32
                or not fused_gains_available(a)):
            return False

        def concretely_zero(x):
            # NumPy leaves (how the spec constructors encode structurally-
            # zero cost terms) stay concrete inside jit/vmap traces, where
            # any jnp op - even on constants - returns a tracer.
            import numpy as np

            if isinstance(x, np.ndarray):
                return not x.any()
            try:
                return not bool(jnp.any(x))
            except jax.errors.TracerBoolConversionError:
                return False
            except jax.errors.ConcretizationTypeError:
                return False

        return all(concretely_zero(x) for x in (a.q, a.r, a.P, a.qf))

    def gains(self, Sigma0=None, method: str = "auto"):
        """Control gains and Kalman gains from the actor's internal model.

        Computed once per parameter set (reference recomputes per trial under
        vmap at ``system.py:157-161``; here hoisting is explicit).

        Args:
            method: ``"auto"`` (fused Pallas kernel where the backend
                compiles it and the spec is in kernel scope, else scans),
                ``"fused"`` (force the kernel; raises on a backend without
                a compiled kernel route), ``"scan"``, ``"sqrt"``
                (QR array-form recursions, :mod:`lqg_tpu.ops.sqrt` - factors
                instead of covariances, guaranteed-PSD propagation for
                extreme conditioning; requires zero affine/cross cost terms),
                or ``"steady"`` (infinite-horizon gains by doubling,
                :mod:`lqg_tpu.ops.dare`, broadcast across the horizon -
                O(log) work instead of O(T); exact in the long-horizon
                interior, approximate near the boundaries).
        """
        with jax.default_matmul_precision("highest"):
            return self._gains(Sigma0, method)

    def _gains(self, Sigma0, method):
        Sigma0 = self._default_Sigma0() if Sigma0 is None else Sigma0
        if method == "steady":
            from lqg_tpu.ops.dare import steady_state

            if _stacked(self.actor):
                raise ValueError("steady gains require a stationary actor "
                                 "spec (time-invariant problem)")
            ss = steady_state(self.actor)
            T = self.horizon
            L = jnp.broadcast_to(ss.L, (T,) + ss.L.shape)
            K = jnp.broadcast_to(ss.K, (T,) + ss.K.shape)
            l = jnp.zeros(L.shape[:-1], dtype=L.dtype)
            return riccati.Gains(L=L, l=l, H=None), K
        if method == "sqrt":
            from lqg_tpu.ops.sqrt import (riccati_backward_sqrt,
                                          kalman_forward_sqrt)

            if self.control_noise is not None:
                raise ValueError(
                    "sqrt gains do not support control-multiplicative noise")
            gains = riccati_backward_sqrt(self.actor, horizon=self.horizon)
            K = kalman_forward_sqrt(self.actor, Sigma0=Sigma0,
                                    horizon=self.horizon)
            return gains, K
        if method == "fused" or (method == "auto" and self._fused_ok()):
            from lqg_tpu.ops.pallas.gains import gains_fused

            require_kernel_route("System.gains(method='fused')")
            batched = jax.tree_util.tree_map(lambda x: x[None], self.actor)
            L, H, K = gains_fused(batched, Sigma0[None], self.horizon)
            L, H, K = L[:, 0], H[:, 0], K[:, 0]
            l = jnp.zeros(L.shape[:-1], dtype=L.dtype)  # zero affine terms
            return riccati.Gains(L=L, l=l, H=H), K
        if self.control_noise is not None:
            gains = riccati.backward_multiplicative(
                self.actor, self.control_noise, horizon=self.horizon)
        else:
            gains = riccati.backward(self.actor, horizon=self.horizon)
        K = kalman.forward(self.actor, Sigma0=Sigma0, horizon=self.horizon)
        return gains, K

    # --- forward simulation ---
    def simulate(self, rng_key, n=1, x0=None, xhat0=None, Sigma0=None,
                 return_all=False):
        """Simulate ``n`` closed-loop trials.

        Returns ``(n, T+1, xdim)`` states with ``x0`` prepended, or
        ``(x, x_hat, y, u)`` when ``return_all`` (reference
        ``system.py:62-140``).
        """
        T, n_ = self.horizon, n
        gains, K = self.gains(Sigma0)
        L_t, l_t = gains.L, gains.l

        x0 = jnp.zeros(self.xdim) if x0 is None else x0
        xhat0 = jnp.zeros(self.bdim) if xhat0 is None else xhat0
        x0 = jnp.broadcast_to(x0, (n_, self.xdim))
        xhat0 = jnp.broadcast_to(xhat0, (n_, self.bdim))

        key_eps, key_eta, key_u = random.split(rng_key, 3)
        eps = random.normal(key_eps, (T, n_, self.dynamics.V.shape[-1]))
        eta = random.normal(key_eta, (T, n_, self.dynamics.W.shape[-1]))
        if self.control_noise is not None:
            eps_u = random.normal(key_u,
                                  (T, n_, self.control_noise.shape[0]))
        else:
            eps_u = jnp.zeros((T, n_, 0))

        A_d = _tl(self.dynamics.A, self.dynamics)
        B_d = _tl(self.dynamics.B, self.dynamics)
        F_d = _tl(self.dynamics.F, self.dynamics)
        V_d = _tl(self.dynamics.V, self.dynamics)
        W_d = _tl(self.dynamics.W, self.dynamics)
        A_a = _tl(self.actor.A, self.actor)
        B_a = _tl(self.actor.B, self.actor)
        F_a = _tl(self.actor.F, self.actor)

        Tbr = lambda M: jnp.broadcast_to(M, (T,) + M.shape[1:])

        Cn = self.control_noise

        def step(carry, inp):
            x, x_hat = carry
            Ad, Bd, Fd, Vd, Wd, Aa, Ba, Fa, Lt, lt, Kt, e, h, eu = inp

            # control from the agent's current belief
            u = x_hat @ Lt.T + lt
            # true dynamics
            x = x @ Ad.T + u @ Bd.T + e @ Vd.T
            if Cn is not None:
                # signal-dependent motor noise: sum_i eps_i C_i u
                x = x + jnp.einsum("nk,kim,nm->ni", eu, Cn, u)
            # observation
            y = x @ Fd.T + h @ Wd.T
            # belief update with the actor's internal model
            x_pred = x_hat @ Aa.T + u @ Ba.T
            x_hat = x_pred + (y - x_pred @ Fa.T) @ Kt.T

            return (x, x_hat), (x, x_hat, y, u)

        xs = (Tbr(A_d), Tbr(B_d), Tbr(F_d), Tbr(V_d), Tbr(W_d),
              Tbr(A_a), Tbr(B_a), Tbr(F_a), L_t, l_t, K, eps, eta, eps_u)
        with jax.default_matmul_precision("highest"):
            _, (x, x_hat, y, u) = lax.scan(step, (x0, xhat0), xs)

        # (T, n, d) -> (n, T+1, d) with initial state prepended
        x = jnp.concatenate([x0[:, None], jnp.moveaxis(x, 0, 1)], axis=1)
        x_hat = jnp.concatenate([xhat0[:, None], jnp.moveaxis(x_hat, 0, 1)],
                                axis=1)
        if return_all:
            return x, x_hat, jnp.moveaxis(y, 0, 1), jnp.moveaxis(u, 0, 1)
        return x

    # --- likelihood machinery ---
    def _check_obs(self, x):
        if x.shape[-1] > self.xdim:
            raise ValueError(
                f"observed data has {x.shape[-1]} dims but the dynamics "
                f"state has only {self.xdim}; the observed dims must be a "
                f"prefix of the state")
        if x.shape[-2] != self.horizon + 1:
            raise ValueError(
                f"data has {x.shape[-2]} time steps but the system horizon "
                f"is T={self.horizon} (expected T+1={self.horizon + 1} steps "
                f"including the initial state)")

    def _joint(self, Sigma0=None) -> gaussian.JointSystem:
        gains, K = self.gains(Sigma0)
        return gaussian.joint_system(self.dynamics, self.actor, gains.L, K,
                                     self.horizon)

    def conditional_moments(self, x, Sigma0=None):
        """Conditional moments for a single trial ``x``: ``(T+1, d)``.

        Returns ``mu (T, j)`` and ``Sigma (T, j, j)`` over the joint
        (state, belief) space, for ``t = 1..T`` (reference
        ``system.py:142-235``).
        """
        joint = self._joint(Sigma0)
        d = x.shape[-1]
        kernel = gaussian.conditional_kernel(joint, d)
        mu = gaussian.conditional_mean(kernel, x[None])[0]
        Sigma = gaussian.conditional_sigma(joint, d)
        return mu, Sigma

    def conditional_distribution(self, x, Sigma0=None) -> GaussianSequence:
        """``p(x_{t+1} | x_{1:t})`` over the observed dims, per trial.

        ``x``: ``(n, T+1, d)``.  Matches reference
        ``conditional_distribution`` (``system.py:237-244``).
        """
        n, Tp1, d = x.shape
        self._check_obs(x)
        joint = self._joint(Sigma0)
        kernel = gaussian.conditional_kernel(joint, d)
        mu = gaussian.conditional_mean(kernel, x)  # (n, T, j)
        Sigma = gaussian.conditional_sigma(joint, d)  # (T, j, j)
        Sigma = jnp.broadcast_to(Sigma[None, :, :d, :d], (n, Tp1 - 1, d, d))
        return GaussianSequence(mu[..., :d], Sigma)

    def log_likelihood(self, x, Sigma0=None, method: str = "auto"):
        """Per-trial log likelihood of ``x[:, 1:]`` given the model.

        Fast paths: data-free covariance work once, trials batched into
        matmuls (see :func:`lqg_tpu.ops.gaussian.trial_log_likelihood`);
        where the backend compiles the Pallas kernels, the whole
        conditioned recursion (and its VJP) runs as one fused kernel
        (:mod:`lqg_tpu.ops.pallas.likelihood`) instead of a scan whose
        per-step cost is the sequential chain of tiny matrix ops.

        Args:
            method: ``"auto"`` (fused kernel where the backend compiles it
                and the joint dims fit, else the sequential scan),
                ``"fused"`` (force the kernel; raises on a backend without
                a compiled kernel route), ``"scan"`` (sequential over T,
                minimal FLOPs), or ``"pscan"`` (associative scan, O(log T)
                depth - for long horizons and for sharding the time axis
                over a mesh, see
                :func:`lqg_tpu.parallel.pscan.trial_log_likelihood_assoc`).
        """
        self._check_obs(x)
        with jax.default_matmul_precision("highest"):
            return self._log_likelihood(x, Sigma0, method)

    def _log_likelihood(self, x, Sigma0, method):
        d = x.shape[-1]
        if method not in ("auto", "fused", "scan", "pscan"):
            raise ValueError(
                f"method must be auto|fused|scan|pscan, got {method!r}")
        if method == "fused":
            require_kernel_route("System.log_likelihood(method='fused')")
        joint = self._joint(Sigma0)
        if method == "auto":
            from lqg_tpu.ops.pallas.likelihood import fused_ll_available

            j = joint.F.shape[-1]
            if (not _FORCE_SCAN and kernel_route() and joint.F.ndim == 3
                    and fused_ll_available(j, d, joint.F.dtype)):
                method = "fused"
            else:
                method = "scan"
        if method == "fused":
            from lqg_tpu.ops.pallas.likelihood import (
                conditioned_log_likelihood_fused)

            Q = joint.G @ mT(joint.G)
            return conditioned_log_likelihood_fused(
                joint.F[None], Q[None], x[None])[0]
        if method == "pscan":
            from lqg_tpu.parallel.pscan import trial_log_likelihood_assoc

            return trial_log_likelihood_assoc(joint, x)
        kernel = gaussian.conditional_kernel(joint, d)
        return gaussian.trial_log_likelihood(kernel, x)

    def belief_tracking_distribution(self, x, Sigma0=None) -> MultivariateNormal:
        """Posterior over the agent's belief given observed states.

        The complementary block of the joint conditional (reference
        ``system.py:250-257``).
        """
        n, Tp1, obs_d = x.shape
        d = self.xdim
        joint = self._joint(Sigma0)
        kernel = gaussian.conditional_kernel(joint, obs_d)
        mu = gaussian.conditional_mean(kernel, x)  # (n, T, j)
        Sigma = gaussian.conditional_sigma(joint, obs_d)  # (T, j, j)
        Sigma = jnp.broadcast_to(Sigma[None, :, d:, d:],
                                 (n, Tp1 - 1, self.bdim, self.bdim))
        return MultivariateNormal(mu[..., d:], Sigma)

    def to_distribution(self, Sigma0=None, xdim=None):
        return LQGDistribution(self, Sigma0=Sigma0, xdim=xdim)

    # NumPyro-compatible name (reference ``system.py:259-260``); the returned
    # object is duck-compatible (log_prob / sample / event_shape).
    to_numpyro = to_distribution

    def _repr_latex_(self) -> str:
        """Render the system matrices as LaTeX in notebooks
        (capability parity with reference ``system.py:262-328``)."""
        import numpy as np

        def first(x):
            x = np.asarray(x)
            return x if x.ndim == 2 else x[0] if x.ndim == 3 else x[(0,) * (x.ndim - 2)]

        def bmatrix(arr) -> str:
            arr = np.atleast_2d(np.asarray(arr))
            rows = [" & ".join(f"{v:.4g}" for v in row) for row in arr]
            return "\\begin{bmatrix}" + "\\\\".join(rows) + "\\end{bmatrix}"

        names = ["A", "B", "F", "V", "W", "Q", "R"]
        dyn = [self.dynamics.A, self.dynamics.B, self.dynamics.F,
               self.dynamics.V, self.dynamics.W]
        act = [self.actor.A, self.actor.B, self.actor.F, self.actor.V,
               self.actor.W, self.actor.Q, self.actor.R]

        out = "\\begin{align*} \\text{Dynamics:}"
        for mat, name in zip(dyn, names):
            out += f" &&{name} = {bmatrix(first(mat))}"
        out += "\\\\\\text{Actor:}"
        for mat, name in zip(act, names):
            out += f" &&{name} = {bmatrix(first(mat))}"
        out += "\\end{align*}"
        return out


def Dynamics(A, B, F, V, W, T=1000) -> LQGSpec:
    """Reference-compatible stacked dynamics spec (``system.py:331-344``)."""
    A = jnp.asarray(A)
    xdim = A.shape[0]
    udim = jnp.asarray(B).shape[1]
    return time_stack_spec(A=A, B=B, F=F, V=V, W=W,
                           Q=jnp.zeros((xdim, xdim)),
                           R=jnp.zeros((udim, udim)), T=T)


def Actor(A, B, F, V, W, Q, R, T=1000) -> LQGSpec:
    """Reference-compatible stacked actor spec (``system.py:347-348``)."""
    return time_stack_spec(A=A, B=B, F=F, V=V, W=W, Q=Q, R=R, T=T)


class LQG(System):
    """Plain LQG: actor and dynamics share one spec (``system.py:351-355``)."""

    def __init__(self, A, B, F, V, W, Q, R, T=1000):
        spec = stationary_spec(A=A, B=B, F=F, V=V, W=W, Q=Q, R=R)
        super().__init__(actor=spec, dynamics=spec, horizon=T)


class LQGDistribution:
    """Trajectory distribution adapter (replaces reference ``NumpyroLQG``,
    ``system.py:358-376``): ``log_prob`` scores observed trajectories,
    ``sample`` simulates."""

    def __init__(self, system: System, xdim=None, Sigma0=None):
        self.system = system
        self.Sigma0 = Sigma0
        self.xdim = system.xdim if xdim is None else xdim
        self.event_shape = (system.T + 1, self.xdim)
        self.batch_shape = ()

    def log_prob(self, x):
        return self.system.log_likelihood(x, Sigma0=self.Sigma0)

    def sample(self, key, sample_shape=()):
        if len(sample_shape) == 0:
            return self.system.simulate(key, n=1, Sigma0=self.Sigma0)[0]
        # honor the FULL sample_shape (n = prod(sample_shape), then reshape)
        n = 1
        for s in sample_shape:
            n *= int(s)
        x = self.system.simulate(key, n=n, Sigma0=self.Sigma0)
        return x.reshape(tuple(sample_shape) + x.shape[1:])

    def __call__(self, rng_key):
        return self.sample(rng_key)
