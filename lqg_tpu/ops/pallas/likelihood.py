"""Fused Pallas kernels (Triton route) for the marginalized trajectory likelihood.

The inverse-OC likelihood (reference ``lqg/system.py:142-248``) is the hot
path: every NUTS leapfrog and every MLE step evaluates it and its gradient.
The XLA implementation (:mod:`lqg_tpu.ops.gaussian`) runs ``lax.scan`` s
over T whose per-step cost is a strictly sequential chain of tiny (j x j)
matrix ops, and on a GPU each scan step pays its own kernel launches.  The
kernels below run the whole conditioned recursion in one program:

* **Layout**: one program per (parameter set, block of trials).  Trials are
  the lanes of a 1-D block; the ``j x j`` joint-state matrices are
  unrolled as per-element values, so each recursion step is straight-line
  FMA code on registers.
* **Data-free covariance as scalars**: the covariance recursion
  (``Sigma_t``, its inverse blocks, the log-determinant) does not depend on
  the data, so a program computes it once, as scalars, from its parameter
  set's ``F`` and ``Q`` read directly (never broadcast across trials); only
  the conditional mean and the quadratic form are per-trial lane vectors.
* **Time loop in-program**: a ``fori_loop`` over all of T carries the
  recursion in values; per-step states are stored at a dynamic time index.
* **Analytic adjoint**: a second kernel runs the reverse-mode recursion
  (derived by hand, see ``_ll_bwd_kernel``) over the stored states, so
  ``jax.value_and_grad`` of the likelihood is also a fused kernel.

Scope: joint dim ``j <= 12``, observed dim ``d <= 4``, float32 - every
shipped tracking model at dim=1 and dim=2 fits; deeper models (delay
registers) run the XLA scan (see ``fused_ll_available``).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.custom_batching
import jax.numpy as jnp
from jax.experimental import pallas as pl

from lqg_tpu.ops.pallas.gains import (_mat, _idx, _matmul, _transpose, _add,
                                      _sub, _neg, _read_t, _write_t,
                                      pallas_gpu_call)

_LOG_2PI = math.log(2.0 * math.pi)

# trials per program (a power of two; 16 and 32 measured equal at the
# data-fit shape on an H100, PERF.md) and warps per program
TRIALS = 32
NUM_WARPS = 1


# --- small symmetric inverse with determinant ---


def _sym_inv_det(A, eps):
    """(inverse, determinant) of a symmetric PD matrix, d <= 4."""
    rows, n, m = A
    assert n == m <= 4
    if n == 1:
        det = rows[0]
        return _mat([1.0 / (det + eps)], 1, 1), det
    if n == 2:
        a, b, _, dd = rows
        det = a * dd - b * b
        inv = 1.0 / (det + eps)
        return _mat([dd * inv, -b * inv, -b * inv, a * inv], 2, 2), det
    if n == 3:
        a, b, c, _, e, f, _, _, i = rows
        A11 = e * i - f * f
        A12 = c * f - b * i
        A13 = b * f - c * e
        det = a * A11 + b * A12 + c * A13
        inv = 1.0 / (det + eps)
        A22 = a * i - c * c
        A23 = b * c - a * f
        A33 = a * e - b * b
        return _mat([A11 * inv, A12 * inv, A13 * inv,
                     A12 * inv, A22 * inv, A23 * inv,
                     A13 * inv, A23 * inv, A33 * inv], 3, 3), det
    # n = 4: blockwise Schur-complement inverse on 2x2 blocks
    # [[A, B], [B^T, C]]^-1 = [[Ai + Ai B Si B^T Ai, -Ai B Si],
    #                          [-Si B^T Ai,           Si       ]]
    # det = det(A) det(S),  S = C - B^T Ai B
    Ab = _mat([_idx(A, r, k) for r in range(2) for k in range(2)], 2, 2)
    Bb = _mat([_idx(A, r, k + 2) for r in range(2) for k in range(2)], 2, 2)
    Cb = _mat([_idx(A, r + 2, k + 2) for r in range(2) for k in range(2)],
              2, 2)
    Ai, detA = _sym_inv_det(Ab, eps)
    AiB = _matmul(Ai, Bb)
    S = _sym(_sub(Cb, _matmul(_transpose(Bb), AiB)))
    Si, detS = _sym_inv_det(S, eps)
    TL = _add(Ai, _matmul(AiB, _matmul(Si, _transpose(AiB))))
    TR = _neg(_matmul(AiB, Si))
    out = [None] * 16
    for r in range(2):
        for k in range(2):
            out[r * 4 + k] = _idx(TL, r, k)
            out[r * 4 + (k + 2)] = _idx(TR, r, k)
            out[(r + 2) * 4 + k] = _idx(TR, k, r)  # (-Si B^T Ai) = TR^T
            out[(r + 2) * 4 + (k + 2)] = _idx(Si, r, k)
    return _mat(out, 4, 4), detA * detS


def _scale(M, s):
    rows, n, m = M
    return _mat([r * s for r in rows], n, m)


def _sym(M):
    rows, n, m = M
    assert n == m
    return _mat([0.5 * (_idx(M, i, k) + _idx(M, k, i))
                 for i in range(n) for k in range(n)], n, n)


def _block(M, rows_n, cols_n):
    """Top-left (rows_n, cols_n) block."""
    return _mat([_idx(M, i, k) for i in range(rows_n)
                 for k in range(cols_n)], rows_n, cols_n)


def _read_x(ref, t, d):
    return _mat([ref[t, k] for k in range(d)], d, 1)


def _read_s(ref, t, n, m):
    """Scalars ``ref[t, 0..n*m)`` of a per-parameter-set schedule."""
    return _mat([ref[t, i] for i in range(n * m)], n, m)


def _write_s(ref, t, M):
    """Store scalars at ``ref[t, 0..n*m)`` (every program of a parameter
    set stores the same data-free values)."""
    rows, n, m = M
    for i in range(n * m):
        ref[t, i] = rows[i]


# --- forward kernel ---


def _neumaier_add(s, comp, v):
    """Compensated accumulate: ``s += v`` keeping the lost low bits in
    ``comp``.  The per-trial quad/logdet accumulators reach O(1e4) nats
    over T~1e3 steps; plain f32 accumulation random-walks ~0.03 nats per
    trial, which (x ~100 trials) is exactly the potential noise floor that
    pinned NUTS step sizes at the flagship fit (lqg_tpu.utils.numerics)."""
    t = s + v
    comp = comp + jnp.where(jnp.abs(s) >= jnp.abs(v), (s - t) + v,
                            (v - t) + s)
    return t, comp


def _ll_fwd_kernel(F_ref, Q_ref, X_ref, ll_ref, SigS_ref, muS_ref,
                   SigT_ref, muT_ref, *, j, d, T, eps):
    """Forward conditioned recursion; stores per-step (Sigma_t, mu_t).

    Recursion (per trial lane; matches
    :func:`lqg_tpu.ops.gaussian.conditional_kernel` + ``trial_log_likelihood``
    exactly):

        init:  Sigma_0 = Q_0,  mu_0 = [x_0; 0]
        t = 0..T-1:
            S = Sigma[:d,:d]; Sinv = S^-1; e = x_t - mu[:d]
            if t >= 1:  quad += e^T Sinv e;  ld += log det S
            FS = F_t Sigma;  P = FS[:, :d];  J = P Sinv
            mu    <- F_t mu + J e
            Sigma <- sym(FS F_t^T + Q_t - J P^T)
        final: S = Sigma_T[:d,:d]; e = x_T - mu_T[:d]; accumulate score
        ll = -0.5 (quad + ld + T d log 2pi)

    ``Sigma``, ``S``, ``J`` and ``ld`` are data-free scalars; ``mu``, ``e``
    and ``quad`` are lane vectors over the program's trials.
    """
    x0 = _read_x(X_ref, 0, d)[0]
    zero = jnp.zeros_like(x0[0])

    def step(t, carry):
        sig_rows, mu_rows, quad_acc, ld_acc, quad_c, ld_c = carry
        Sigma = _mat(list(sig_rows), j, j)
        mu = _mat(list(mu_rows), j, 1)

        # store carries for the backward pass
        _write_s(SigS_ref, t, Sigma)
        _write_t(muS_ref, t, mu)

        F = _read_s(F_ref, t, j, j)
        Q = _read_s(Q_ref, t, j, j)

        S = _block(Sigma, d, d)
        Sinv, det = _sym_inv_det(S, eps)
        e = _sub(_read_x(X_ref, t, d), _block(mu, d, 1))

        # score x_t | x_{<t} for t >= 1
        mask = (t >= 1).astype(zero.dtype)
        Se = _matmul(Sinv, e)
        quad = _idx(e, 0, 0) * _idx(Se, 0, 0)
        for r in range(1, d):
            quad = quad + _idx(e, r, 0) * _idx(Se, r, 0)
        quad_acc, quad_c = _neumaier_add(quad_acc, quad_c, mask * quad)
        ld_acc, ld_c = _neumaier_add(ld_acc, ld_c, mask * jnp.log(det))

        FS = _matmul(F, Sigma)
        P = _mat([_idx(FS, r, k) for r in range(j) for k in range(d)], j, d)
        J = _matmul(P, Sinv)

        mu_new = _add(_matmul(F, mu), _matmul(J, e))
        Sigma_new = _sym(_sub(_add(_matmul(FS, _transpose(F)), Q),
                              _matmul(J, _transpose(P))))

        return (tuple(Sigma_new[0]), tuple(mu_new[0]),
                quad_acc, ld_acc, quad_c, ld_c)

    s0 = jnp.zeros((), zero.dtype)
    carry0 = (tuple(_read_s(Q_ref, 0, j, j)[0]),
              tuple(x0[i] if i < d else zero for i in range(j)),
              zero, s0, zero, s0)
    sig_f, mu_f, quad_f, ld_f, quad_cf, ld_cf = jax.lax.fori_loop(
        0, T, step, carry0)

    Sigma = _mat(list(sig_f), j, j)
    mu = _mat(list(mu_f), j, 1)
    _write_s(SigT_ref, 0, Sigma)   # final state for the backward pass
    _write_t(muT_ref, 0, mu)

    Sinv, det = _sym_inv_det(_block(Sigma, d, d), eps)
    e = _sub(_read_x(X_ref, T, d), _block(mu, d, 1))
    Se = _matmul(Sinv, e)
    quad = _idx(e, 0, 0) * _idx(Se, 0, 0)
    for r in range(1, d):
        quad = quad + _idx(e, r, 0) * _idx(Se, r, 0)
    # fold the compensation terms (small) before the large partials
    total = (quad_cf + ld_cf + quad + jnp.log(det)) \
        + quad_f + ld_f + T * d * _LOG_2PI
    ll_ref[...] = -0.5 * total


# --- backward (adjoint) kernel ---


def _ll_bwd_kernel(F_ref, X_ref, w_ref, SigS_ref, muS_ref, SigT_ref, muT_ref,
                   Fbar_ref, Qbar_ref, Xbar_ref, *, j, d, T, eps):
    """Reverse-mode recursion of :func:`_ll_fwd_kernel`.

    Also emits the DATA cotangent ``Xbar`` (``e = x_t - mu[:d]`` routes
    ``ebar`` into ``x_t``; the init ``mu_0 = [x_0; 0]`` additionally routes
    the final ``mubar[:d]`` into ``x_0``; the terminal score routes
    ``-w S^{-1} e`` into ``x_T``) - so differentiating the likelihood
    through trajectories (amortized inference, adversarial probes) is exact
    on the fused path too.

    Hand-derived adjoints; notation as in the forward docstring, with
    ``w`` the per-trial output cotangent (d ll).  For each step t (reverse):

        Sbar' <- sym(Sbar')                       [Sigma' was symmetrized]
        Qbar_t = Sbar'
        FSbar  = Sbar' F;   Fbar_t = Sbar' FS + mubar' mu^T
        Jbar   = -Sbar' P + mubar' e^T
        Pbar   = -Sbar' J + Jbar Sinv
        Sinvbar= P^T Jbar  [- (w/2) e e^T  if t>=1]
        ebar   = J^T mubar'  [- w Sinv e   if t>=1]
        Sbar   = -Sinv Sinvbar Sinv  [- (w/2) Sinv  if t>=1]
        mubar  = F^T mubar';  mubar[:d] -= ebar
        FSbar[:, :d] += Pbar
        Fbar_t += FSbar Sigma;   Sigmabar = F^T FSbar
        Sigmabar[:d,:d] += sym(Sbar)
        carry (Sigmabar, mubar)

    The final-score adjoint seeds the carry at t = T; at t = 0 the carry's
    Sigma-cotangent is folded into ``Qbar_0`` (Sigma_0 = Q_0).  Every
    cotangent is per trial (it carries ``w`` and the data); the wrapper sums
    ``Fbar``/``Qbar`` over trials.
    """
    w = w_ref[...]
    zero = jnp.zeros_like(w)

    # seed: adjoint of the final score on (Sigma_T, mu_T)
    Sigma = _read_s(SigT_ref, 0, j, j)
    mu = _read_t(muT_ref, 0, j, 1)
    Sinv, _ = _sym_inv_det(_block(Sigma, d, d), eps)
    e = _sub(_read_x(X_ref, T, d), _block(mu, d, 1))
    Se = _matmul(Sinv, e)
    # ebar = -w Sinv e ; mubar[:d] = -ebar = w Sinv e ; xTbar = ebar
    _write_t(Xbar_ref, T, _mat([-w * _idx(Se, i, 0) for i in range(d)],
                               d, 1))
    mbar0 = tuple(w * _idx(Se, i, 0) if i < d else zero for i in range(j))
    # Sinvbar = -(w/2) e e^T ; Sbar = -(w/2) Sinv - Sinv Sinvbar Sinv
    #         = -(w/2) Sinv + (w/2) (Sinv e)(Sinv e)^T
    sbar0 = tuple(0.5 * w * (_idx(Se, r, 0) * _idx(Se, k, 0)
                             - _idx(Sinv, r, k))
                  if (r < d and k < d) else zero
                  for r in range(j) for k in range(j))

    def step(i, carry):
        sbar_rows, mbar_rows = carry
        t = T - 1 - i

        Sigma = _read_s(SigS_ref, t, j, j)
        mu = _read_t(muS_ref, t, j, 1)
        F = _read_s(F_ref, t, j, j)

        # recompute forward intermediates
        S = _block(Sigma, d, d)
        Sinv, _ = _sym_inv_det(S, eps)
        e = _sub(_read_x(X_ref, t, d), _block(mu, d, 1))
        FS = _matmul(F, Sigma)
        P = _mat([_idx(FS, r, k) for r in range(j) for k in range(d)], j, d)
        J = _matmul(P, Sinv)

        Sbar_n = _sym(_mat(list(sbar_rows), j, j))   # sym(Sigmabar')
        mbar_n = _mat(list(mbar_rows), j, 1)          # mubar'

        Qbar = Sbar_n
        FSbar = _matmul(Sbar_n, F)
        Fbar = _add(_matmul(Sbar_n, FS),
                    _matmul(mbar_n, _transpose(mu)))
        Jbar = _add(_neg(_matmul(Sbar_n, P)),
                    _matmul(mbar_n, _transpose(e)))
        Pbar = _add(_neg(_matmul(Sbar_n, J)), _matmul(Jbar, Sinv))
        Sinvbar = _matmul(_transpose(P), Jbar)
        ebar = _matmul(_transpose(J), mbar_n)

        mask = (t >= 1).astype(zero.dtype)
        Se = _matmul(Sinv, e)
        # score adjoints (t >= 1): ebar -= w Sinv e;
        # Sinvbar -= (w/2) e e^T;  Sbar gets -(w/2) Sinv (logdet term)
        ebar = _sub(ebar, _scale(Se, mask * w))
        Sinvbar = _sub(Sinvbar, _scale(_matmul(e, _transpose(e)),
                                       mask * 0.5 * w))
        Sbar = _neg(_matmul(Sinv, _matmul(Sinvbar, Sinv)))
        Sbar = _sub(Sbar, _scale(Sinv, mask * 0.5 * w))

        # mubar = F^T mubar'; mubar[:d] -= ebar
        mubar = _matmul(_transpose(F), mbar_n)
        mu_rows = list(mubar[0])
        for r in range(d):
            mu_rows[r] = mu_rows[r] - _idx(ebar, r, 0)
        mubar = _mat(mu_rows, j, 1)

        # data cotangent: xbar_t = ebar (+ mubar_0[:d] at t = 0 via the
        # init mu_0 = [x_0; 0])
        is_t0 = (t == 0).astype(zero.dtype)
        xrows = [(_idx(ebar, r, 0) + is_t0 * mu_rows[r]) for r in range(d)]
        _write_t(Xbar_ref, t, _mat(xrows, d, 1))

        # FSbar[:, :d] += Pbar
        fs_rows = list(FSbar[0])
        for r in range(j):
            for k in range(d):
                fs_rows[r * j + k] = fs_rows[r * j + k] + _idx(Pbar, r, k)
        FSbar = _mat(fs_rows, j, j)

        Fbar = _add(Fbar, _matmul(FSbar, Sigma))  # Sigma symmetric
        Sigmabar = _matmul(_transpose(F), FSbar)

        # Sigmabar[:d,:d] += sym(Sbar)
        Sbar_s = _sym(Sbar)
        sg_rows = list(Sigmabar[0])
        for r in range(d):
            for k in range(d):
                sg_rows[r * j + k] = sg_rows[r * j + k] + _idx(Sbar_s, r, k)
        Sigmabar = _mat(sg_rows, j, j)

        # t = 0: Sigma_0 = Q_0, so the carry cotangent folds into Qbar_0
        Qbar = _add(Qbar, _scale(_sym(Sigmabar), is_t0))

        _write_t(Fbar_ref, t, Fbar)
        _write_t(Qbar_ref, t, Qbar)
        return (tuple(Sigmabar[0]), tuple(mubar[0]))

    jax.lax.fori_loop(0, T, step, (sbar0, mbar0))


# --- host-side wrappers ---


def fused_ll_available(j: int, d: int, dtype) -> bool:
    """Kernel scope: the dim=1 tracking models (BoundedActor j = 4,
    SubjectiveActor j = 5).  The kernels unroll ~j^3 operations per step:
    at j = 5 they compile in seconds, while at j = 8 the GPU compile ran
    past minutes (PERF.md), so larger joint states (the dim=2 family,
    delay registers) run the XLA scan."""
    return j <= 5 and d <= 4 and dtype == jnp.float32


def _trial_lanes(X, trials):
    """(P, n, T+1, d) -> (P, T+1, d, Np): trials last, edge-padded to a
    whole number of lane blocks."""
    n = X.shape[1]
    Np = -(-n // trials) * trials
    Xl = jnp.moveaxis(X, 1, -1)
    if Np != n:
        Xl = jnp.pad(Xl, ((0, 0), (0, 0), (0, 0), (0, Np - n)), mode="edge")
    return Xl


@functools.partial(jax.jit, static_argnames=("interpret", "trials"))
def _ll_fwd_call(F, Q, X, interpret=False, trials=TRIALS):
    """Run the forward kernel.

    Args:
        F, Q: ``(P, T, j, j)`` joint transition / noise covariance.
        X: ``(P, n, T+1, d)`` observed trajectories.

    Returns:
        ``(ll (P, n), stores)`` where stores feed the backward kernel.
    """
    P, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    dtype = F.dtype
    Xl = _trial_lanes(X, trials)
    Np = Xl.shape[-1]

    per_set = lambda *shape: pl.BlockSpec(
        (None,) + shape, lambda p, b: (p,) + (0,) * len(shape))
    per_trial = lambda *shape: pl.BlockSpec(
        (None,) + shape + (trials,),
        lambda p, b: (p,) + (0,) * len(shape) + (b,))

    ll, SigS, muS, SigT, muT = pallas_gpu_call(
        functools.partial(_ll_fwd_kernel, j=j, d=d, T=T, eps=1e-12),
        grid=(P, Np // trials),
        in_specs=[per_set(T, j * j), per_set(T, j * j),
                  per_trial(T + 1, d)],
        out_specs=(per_trial(), per_set(T, j * j), per_trial(T, j),
                   per_set(1, j * j), per_trial(1, j)),
        out_shape=(
            jax.ShapeDtypeStruct((P, Np), dtype),
            jax.ShapeDtypeStruct((P, T, j * j), dtype),
            jax.ShapeDtypeStruct((P, T, j, Np), dtype),
            jax.ShapeDtypeStruct((P, 1, j * j), dtype),
            jax.ShapeDtypeStruct((P, 1, j, Np), dtype),
        ),
        interpret=interpret, num_warps=NUM_WARPS, name="lqg_ll_forward",
    )(F.reshape(P, T, j * j), Q.reshape(P, T, j * j), Xl)
    return ll[:, :n], (SigS, muS, SigT, muT, Xl)


@functools.partial(jax.jit, static_argnames=("interpret", "trials"))
def _ll_bwd_call(F, stores, llbar, interpret=False, trials=TRIALS):
    """Run the adjoint kernel; returns ``(Fbar, Qbar, Xbar)`` with Fbar and
    Qbar shaped like F (summed over trials) and Xbar like X."""
    SigS, muS, SigT, muT, Xl = stores
    P, T, j, _ = F.shape
    n = llbar.shape[1]
    d = Xl.shape[2]
    Np = Xl.shape[-1]
    dtype = F.dtype
    w = jnp.pad(llbar, ((0, 0), (0, Np - n)))   # padded trials: zero weight

    per_set = lambda *shape: pl.BlockSpec(
        (None,) + shape, lambda p, b: (p,) + (0,) * len(shape))
    per_trial = lambda *shape: pl.BlockSpec(
        (None,) + shape + (trials,),
        lambda p, b: (p,) + (0,) * len(shape) + (b,))

    Fbar, Qbar, Xbar = pallas_gpu_call(
        functools.partial(_ll_bwd_kernel, j=j, d=d, T=T, eps=1e-12),
        grid=(P, Np // trials),
        in_specs=[per_set(T, j * j), per_trial(T + 1, d), per_trial(),
                  per_set(T, j * j), per_trial(T, j), per_set(1, j * j),
                  per_trial(1, j)],
        out_specs=(per_trial(T, j * j), per_trial(T, j * j),
                   per_trial(T + 1, d)),
        out_shape=(
            jax.ShapeDtypeStruct((P, T, j * j, Np), dtype),
            jax.ShapeDtypeStruct((P, T, j * j, Np), dtype),
            jax.ShapeDtypeStruct((P, T + 1, d, Np), dtype),
        ),
        interpret=interpret, num_warps=NUM_WARPS, name="lqg_ll_adjoint",
    )(F.reshape(P, T, j * j), Xl, w, SigS, muS, SigT, muT)

    def per_set_sum(x):
        return x[..., :n].sum(axis=-1).reshape(P, T, j, j)

    return per_set_sum(Fbar), per_set_sum(Qbar), \
        jnp.moveaxis(Xbar[..., :n], -1, 1)


# --- custom vmap: fold mapped axes into the kernel's P axis ---
#
# Under NUTS, chains arrive via jax.vmap over the model potential.  The
# default pallas batching rule adds a grid dimension per mapped axis; these
# rules instead fold the vmap axis into the parameter-set axis P, so one
# launch covers every chain and the wrapper's layout code runs once.
#
# custom_vmap cannot be differentiated through, so it sits INSIDE
# custom_vjp: autodiff splits into fwd/bwd first, then vmap maps each
# through its folding rule.  Residuals are the honest primal inputs
# (F, Q, X) - the backward pass re-runs the forward kernel to regenerate
# the per-step stores rather than threading them through the batcher.


def _fold(axis_size, batched, *args):
    """Collapse a leading vmap axis into the kernel's P axis."""
    out = []
    for a, b in zip(args, batched):
        if not b:
            a = jnp.broadcast_to(a[None], (axis_size,) + a.shape)
        out.append(a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:]))
    return out


@functools.lru_cache(maxsize=None)
def _ll_cv(interpret: bool):
    """(forward, gradient) custom_vmap pair for one interpret setting."""

    def fwd(F, Q, X):
        return _ll_fwd_call(F, Q, X, interpret=interpret)[0]

    fwd_cv = jax.custom_batching.custom_vmap(fwd)

    @fwd_cv.def_vmap
    def _fwd_rule(axis_size, in_batched, F, Q, X):
        Ff, Qf, Xf = _fold(axis_size, in_batched, F, Q, X)
        ll = fwd_cv(Ff, Qf, Xf)
        return ll.reshape((axis_size, -1) + ll.shape[1:]), True

    def grads(F, Q, X, llbar):
        _, stores = _ll_fwd_call(F, Q, X, interpret=interpret)
        return _ll_bwd_call(F, stores, llbar, interpret=interpret)

    bwd_cv = jax.custom_batching.custom_vmap(grads)

    @bwd_cv.def_vmap
    def _bwd_rule(axis_size, in_batched, F, Q, X, llbar):
        Ff, Qf, Xf, lf = _fold(axis_size, in_batched, F, Q, X, llbar)
        Fbar, Qbar, Xbar = bwd_cv(Ff, Qf, Xf, lf)
        unfold = lambda a: a.reshape((axis_size, -1) + a.shape[1:])
        return (unfold(Fbar), unfold(Qbar), unfold(Xbar)), (True, True, True)

    return fwd_cv, bwd_cv


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def conditioned_log_likelihood_fused(F, Q, X, interpret=False):
    """Marginalized trajectory log likelihood, fused into one kernel.

    Args:
        F: ``(P, T, j, j)`` joint (state, belief) transition schedules.
        Q: ``(P, T, j, j)`` joint noise covariances ``G G^T``.
        X: ``(P, n, T+1, d)`` observed trajectories (first ``d`` joint dims).
        interpret: run in the Pallas interpreter instead of compiling.

    Returns:
        ``(P, n)`` per-trial log likelihoods of ``X[..., 1:, :]`` - identical
        to :func:`lqg_tpu.ops.gaussian.trial_log_likelihood` on the same
        joint system.  Differentiable (fused analytic adjoint kernel) and
        vmap-aware (mapped axes fold into the parameter-set axis).
    """
    return _ll_cv(interpret)[0](F, Q, X)


def _clf_fwd(F, Q, X, interpret):
    return _ll_cv(interpret)[0](F, Q, X), (F, Q, X)


def _clf_bwd(interpret, res, llbar):
    return _ll_cv(interpret)[1](*res, llbar)


conditioned_log_likelihood_fused.defvjp(_clf_fwd, _clf_bwd)
