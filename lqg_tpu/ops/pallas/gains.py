"""Fused Pallas kernels (Triton route): Riccati backward + Kalman forward gains.

The gains are thousands of *tiny* (n <= 4) LQG problems: each step of the
XLA scan (:mod:`lqg_tpu.ops.riccati`, :mod:`lqg_tpu.ops.kalman`) is a chain
of small dependent matrix ops, and on a GPU every step of a ``lax.scan``
pays its own kernel launches.  These kernels run the whole horizon inside
one program instead:

* **Layout**: parameter particles are the lanes of a 1-D block
  (``lanes``, a power of two); the n x n matrix elements are unrolled as
  separate lane vectors, so every matrix product is straight-line FMA code
  on registers.  The grid covers only the particle batch.
* **Time loop in-program**: a ``fori_loop`` over all of T carries the
  Riccati and covariance recursions in values (registers); each step's
  gains are stored at a dynamic time index.
* **Closed-form small inverses**: control dims m <= 2 and observation dims
  p <= 3 use explicit symmetric inverses (no factorization in the kernel).

Both recursions (Riccati backward for L, Kalman forward for K) run in ONE
kernel - they are independent, so both carries share the loop, L/H
streaming to reverse-time slots and K forward.

Scope: stationary (time-invariant) specs with zero affine cost terms -
exactly the shape of every model in the zoo.  The general/stacked path
stays on :mod:`lqg_tpu.ops.riccati` / :mod:`lqg_tpu.ops.kalman`.
Gradients: :func:`gains_fused` wraps the kernel in a custom VJP whose
backward pass is the analytic adjoint kernel (:func:`_gains_adjoint_kernel`).

Every entry point takes ``interpret``: ``True`` runs the kernels in the
Pallas interpreter (CPU tests); the default compiles them for the GPU.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from lqg_tpu.spec import LQGSpec

# particles per program (a power of two) and warps per program: the best
# of the measured 32/1, 64/1, 64/2, 128/1, 128/2, 128/4 at B=16384, T=1000
# on an H100 (PERF.md)
LANES = 128
NUM_WARPS = 4

# --- tiny-matrix algebra on lists of lane vectors (or scalars) ---


def _mat(rows: Sequence, n: int, m: int):
    assert len(rows) == n * m, (len(rows), n, m)
    return (list(rows), n, m)


def _idx(M, i, j):
    rows, n, m = M
    return rows[i * m + j]


def _matmul(A, B):
    ra, n, k = A
    rb, k2, m = B
    assert k == k2
    out = []
    for i in range(n):
        for j in range(m):
            acc = _idx(A, i, 0) * _idx(B, 0, j)
            for t in range(1, k):
                acc = acc + _idx(A, i, t) * _idx(B, t, j)
            out.append(acc)
    return _mat(out, n, m)


def _transpose(A):
    rows, n, m = A
    return _mat([rows[i * m + j] for j in range(m) for i in range(n)], m, n)


def _add(A, B):
    ra, n, m = A
    rb, n2, m2 = B
    assert (n, m) == (n2, m2)
    return _mat([a + b for a, b in zip(ra, rb)], n, m)


def _sub(A, B):
    ra, n, m = A
    rb, _, _ = B
    return _mat([a - b for a, b in zip(ra, rb)], n, m)


def _neg(A):
    rows, n, m = A
    return _mat([-a for a in rows], n, m)


def _sym_inv(A, eps):
    """Closed-form inverse of a symmetric PD matrix, n <= 3."""
    rows, n, m = A
    assert n == m <= 3
    if n == 1:
        return _mat([1.0 / (rows[0] + eps)], 1, 1)
    if n == 2:
        a, b, _, d = rows
        inv = 1.0 / (a * d - b * b + eps)
        return _mat([d * inv, -b * inv, -b * inv, a * inv], 2, 2)
    a, b, c, _, e, f, _, _, i = rows  # symmetric: use upper triangle
    A11 = e * i - f * f
    A12 = c * f - b * i
    A13 = b * f - c * e
    inv = 1.0 / (a * A11 + b * A12 + c * A13 + eps)
    A22 = a * i - c * c
    A23 = b * c - a * f
    A33 = a * e - b * b
    return _mat([A11 * inv, A12 * inv, A13 * inv,
                 A12 * inv, A22 * inv, A23 * inv,
                 A13 * inv, A23 * inv, A33 * inv], 3, 3)


def _read(ref, n: int, m: int):
    """(n, m) matrix from the leading rows of a (rows, lanes) block."""
    return _mat([ref[i] for i in range(n * m)], n, m)


def _read_t(ref, t, n: int, m: int):
    return _mat([ref[t, i] for i in range(n * m)], n, m)


def _write_t(ref, t, M):
    rows, n, m = M
    for i in range(n * m):
        ref[t, i] = jnp.broadcast_to(rows[i], ref.shape[-1:])


def _write(ref, M):
    rows, n, m = M
    for i in range(n * m):
        ref[i] = jnp.broadcast_to(rows[i], ref.shape[-1:])


def pallas_gpu_call(kernel, *, grid, in_specs, out_specs, out_shape,
                    interpret, num_warps, name=None):
    """``pallas_call`` on the Triton route, or in the interpreter when the
    caller asks for it."""
    return pl.pallas_call(
        kernel, grid=grid, in_specs=in_specs, out_specs=out_specs,
        out_shape=out_shape, interpret=interpret, name=name,
        compiler_params=None if interpret else plt.CompilerParams(
            num_warps=num_warps, num_stages=1))


# --- kernels ---


def _gains_kernel(*refs, n, m, p, T, eps, emit_stores=False):
    """Riccati backward AND Kalman forward in ONE program per lane block.

    The two recursions are independent (control gains come from the
    backward cost-to-go pass, estimator gains from the forward covariance
    pass), so both carries ride the same loop: the Riccati carry writes its
    outputs at the reverse-time slot while the Kalman carry writes forward.

    With ``emit_stores`` the per-step carries (Riccati ``S_t`` entering the
    step that emits ``L_t``, Kalman ``P_t`` entering the predict) stream to
    two extra outputs - the residues :func:`_gains_adjoint_kernel` needs.
    """
    if emit_stores:
        (A_ref, B_ref, Q_ref, R_ref, Qf_ref, F_ref, VV_ref, WW_ref,
         Sigma0_ref, L_ref, H_ref, K_ref, Sst_ref, Pst_ref) = refs
    else:
        (A_ref, B_ref, Q_ref, R_ref, Qf_ref, F_ref, VV_ref, WW_ref,
         Sigma0_ref, L_ref, H_ref, K_ref) = refs
        Sst_ref = Pst_ref = None

    A = _read(A_ref, n, n)
    Bm = _read(B_ref, n, m)
    Q = _read(Q_ref, n, n)
    R = _read(R_ref, m, m)
    F = _read(F_ref, p, n)
    VVt = _read(VV_ref, n, n)
    WWt = _read(WW_ref, p, p)
    At = _transpose(A)
    Bt = _transpose(Bm)
    Ft = _transpose(F)

    def step(i, carry):
        S_rows, P_rows = carry

        # --- Riccati backward (reverse slot tt) ---
        S = _mat(list(S_rows), n, n)
        SB = _matmul(S, Bm)
        SA = _matmul(S, A)
        H = _add(R, _matmul(Bt, SB))
        G = _matmul(Bt, SA)
        Hinv = _sym_inv(H, eps)
        L = _neg(_matmul(Hinv, G))
        Lt_ = _transpose(L)
        HL = _matmul(H, L)
        S_new = _add(_add(Q, _matmul(At, SA)),
                     _add(_matmul(Lt_, HL),
                          _add(_matmul(Lt_, G), _matmul(_transpose(G), L))))
        tt = T - 1 - i
        _write_t(L_ref, tt, L)
        _write_t(H_ref, tt, H)
        if Sst_ref is not None:
            _write_t(Sst_ref, tt, S)

        # --- Kalman forward (slot i) ---
        P = _mat(list(P_rows), n, n)
        if Pst_ref is not None:
            _write_t(Pst_ref, i, P)
        P = _add(_matmul(A, _matmul(P, At)), VVt)
        PFt = _matmul(P, Ft)
        Gk = _add(_matmul(F, PFt), WWt)
        Gkinv = _sym_inv(Gk, eps)
        K = _matmul(PFt, Gkinv)
        P_new = _sub(P, _matmul(K, _transpose(PFt)))
        _write_t(K_ref, i, K)

        return (tuple(S_new[0]), tuple(P_new[0]))

    carry0 = (tuple(_read(Qf_ref, n, n)[0]),
              tuple(_read(Sigma0_ref, n, n)[0]))
    jax.lax.fori_loop(0, T, step, carry0)


def _gains_adjoint_kernel(A_ref, B_ref, R_ref, F_ref, VV_ref, WW_ref,
                          Sst_ref, Pst_ref, Lbar_ref, Hbar_ref, Kbar_ref,
                          Abar_ref, Bbar_ref, Qbar_ref, Rbar_ref, Qfbar_ref,
                          Fbar_ref, VVbar_ref, WWbar_ref, S0bar_ref,
                          *, n, m, p, T, eps):
    """Analytic adjoint of :func:`_gains_kernel` - ONE program per lane block.

    Reverse-mode of the Riccati backward pass runs FORWARD in time (its
    primal ran backward), and reverse-mode of the Kalman forward pass runs
    BACKWARD - so, exactly like the primal, the two adjoint recursions
    interleave in one loop with independent carries, one reading its
    streams ascending and the other descending.  Forward intermediates
    (H, L, Gk, K, ...) are recomputed from the stored carries ``S_t`` /
    ``P_t`` - identical arithmetic to the primal - instead of being
    streamed from memory.

    Hand-derived adjoints (tr(Xbar^T dX) convention), Riccati step:

        Lb  += HL Sb^T + G Sb^T + G Sb + H L Sb          [from S+ terms]
        Hb  += L Sb L^T + Hinv Lb G^T Hinv               [S+ and L=-Hinv G]
        Gbar = L Sb + L Sb^T - Hinv Lb
        Rbar += Hb;  Qbar += Sb
        SBbar = B Hb;        SAbar = A Sb + B Gbar
        Abar += SA Sb^T + S SAbar
        Bbar += SA Gbar^T + SB Hb^T + S SBbar
        Sb'  = SBbar B^T + SAbar A^T                      [carry]

    Kalman step (Pp/PFt/Gk/K recomputed from stored P):

        Kb'   = Kb - Pb PFt
        PFtb  = -Pb^T K + Kb' Gki
        Gkbar = -Gki (PFt^T Kb') Gki
        WWbar += Gkbar;  Fbar += Gkbar PFt^T + PFtb'^T Pp
        Ppbar = Pb + (PFtb + F^T Gkbar) F
        VVbar += Ppbar;  Abar += (Ppbar + Ppbar^T) A P
        Pb'   = A^T Ppbar A                               [carry]

    Cotangents for the stationary inputs accumulate in the loop carry and
    are written once at the end, along with ``Qfbar`` (the final
    Riccati-adjoint carry: the primal's initial carry was ``Qf``) and
    ``Sigma0bar`` (final Kalman-adjoint carry).
    """
    A = _read(A_ref, n, n)
    Bm = _read(B_ref, n, m)
    R = _read(R_ref, m, m)
    F = _read(F_ref, p, n)
    VVt = _read(VV_ref, n, n)
    WWt = _read(WW_ref, p, p)
    At = _transpose(A)
    Bt = _transpose(Bm)
    Ft = _transpose(F)

    zero = jnp.zeros_like(_idx(A, 0, 0))

    def zmat(a, b):
        return tuple(zero for _ in range(a * b))

    def step(i, carry):
        (sb_rows, pb_rows, aA_r, aB_r, aQ_r, aR_r, aF_r, aV_r, aW_r) = carry
        aA = _mat(list(aA_r), n, n)
        aB = _mat(list(aB_r), n, m)
        aQ = _mat(list(aQ_r), n, n)
        aR = _mat(list(aR_r), m, m)
        aF = _mat(list(aF_r), p, n)
        aV = _mat(list(aV_r), n, n)
        aW = _mat(list(aW_r), p, p)

        # --- Riccati adjoint (ascending slot i) ---
        S = _read_t(Sst_ref, i, n, n)
        Sb = _mat(list(sb_rows), n, n)
        Lb0 = _read_t(Lbar_ref, i, m, n)
        Hb0 = _read_t(Hbar_ref, i, m, m)

        SB = _matmul(S, Bm)
        SA = _matmul(S, A)
        H = _add(R, _matmul(Bt, SB))
        G = _matmul(Bt, SA)
        Hinv = _sym_inv(H, eps)
        L = _neg(_matmul(Hinv, G))
        HL = _matmul(H, L)

        Sbt = _transpose(Sb)
        Lb = _add(Lb0, _add(_matmul(HL, Sbt),
                            _add(_matmul(G, Sbt),
                                 _add(_matmul(G, Sb),
                                      _matmul(H, _matmul(L, Sb))))))
        Hb = _add(Hb0, _matmul(L, _matmul(Sb, _transpose(L))))
        HinvLb = _matmul(Hinv, Lb)
        Hb = _add(Hb, _matmul(HinvLb, _matmul(_transpose(G), Hinv)))
        Gbar = _sub(_add(_matmul(L, Sb), _matmul(L, Sbt)), HinvLb)

        aR = _add(aR, Hb)
        aQ = _add(aQ, Sb)
        SBbar = _matmul(Bm, Hb)
        SAbar = _add(_matmul(A, Sb), _matmul(Bm, Gbar))
        aA = _add(aA, _add(_matmul(SA, Sbt), _matmul(S, SAbar)))
        aB = _add(aB, _add(_matmul(SA, _transpose(Gbar)),
                           _add(_matmul(SB, _transpose(Hb)),
                                _matmul(S, SBbar))))
        Sb_new = _add(_matmul(SBbar, Bt), _matmul(SAbar, At))

        # --- Kalman adjoint (descending slot tt) ---
        tt = T - 1 - i
        P = _read_t(Pst_ref, tt, n, n)
        Pb = _mat(list(pb_rows), n, n)
        Kb0 = _read_t(Kbar_ref, tt, n, p)

        Pp = _add(_matmul(A, _matmul(P, At)), VVt)
        PFt = _matmul(Pp, Ft)
        Gk = _add(_matmul(F, PFt), WWt)
        Gki = _sym_inv(Gk, eps)
        K = _matmul(PFt, Gki)

        Kb = _sub(Kb0, _matmul(Pb, PFt))
        PFtb = _add(_neg(_matmul(_transpose(Pb), K)), _matmul(Kb, Gki))
        Gkbar = _neg(_matmul(Gki, _matmul(_transpose(PFt),
                                          _matmul(Kb, Gki))))
        aW = _add(aW, Gkbar)
        aF = _add(aF, _matmul(Gkbar, _transpose(PFt)))
        PFtb_full = _add(PFtb, _matmul(Ft, Gkbar))
        aF = _add(aF, _matmul(_transpose(PFtb_full), Pp))
        Ppbar = _add(Pb, _matmul(PFtb_full, F))
        aV = _add(aV, Ppbar)
        aA = _add(aA, _matmul(_add(Ppbar, _transpose(Ppbar)),
                              _matmul(A, P)))
        Pb_new = _matmul(At, _matmul(Ppbar, A))

        return (tuple(Sb_new[0]), tuple(Pb_new[0]),
                tuple(aA[0]), tuple(aB[0]), tuple(aQ[0]), tuple(aR[0]),
                tuple(aF[0]), tuple(aV[0]), tuple(aW[0]))

    carry0 = (zmat(n, n), zmat(n, n), zmat(n, n), zmat(n, m), zmat(n, n),
              zmat(m, m), zmat(p, n), zmat(n, n), zmat(p, p))
    (sb_f, pb_f, aA_f, aB_f, aQ_f, aR_f, aF_f, aV_f, aW_f) = \
        jax.lax.fori_loop(0, T, step, carry0)
    _write(Abar_ref, _mat(list(aA_f), n, n))
    _write(Bbar_ref, _mat(list(aB_f), n, m))
    _write(Qbar_ref, _mat(list(aQ_f), n, n))
    _write(Rbar_ref, _mat(list(aR_f), m, m))
    _write(Qfbar_ref, _mat(list(sb_f), n, n))
    _write(Fbar_ref, _mat(list(aF_f), p, n))
    _write(VVbar_ref, _mat(list(aV_f), n, n))
    _write(WWbar_ref, _mat(list(aW_f), p, p))
    _write(S0bar_ref, _mat(list(pb_f), n, n))


def _scan_gains(spec: LQGSpec, Sigma0: jnp.ndarray, horizon: int):
    """XLA-scan gains (batched), the reference twin of the kernel."""
    from lqg_tpu.ops import riccati, kalman

    g = riccati.backward(spec, horizon=horizon, regularize="none")
    K = kalman.forward(spec, Sigma0=Sigma0, horizon=horizon)
    return g.L, g.H, K


@functools.lru_cache(maxsize=None)
def _gains_fwd_cv(horizon: int, interpret: bool):
    """custom_vmap wrapper folding mapped axes into the particle axis.

    Without this, vmap over ``gains_fused`` (e.g. NUTS chains vmapped over
    the model potential) hits the default pallas batching rule - one grid
    dimension per mapped axis, each chain's program a separate lane block.
    Folding rides all chains on the lanes of the same programs instead.
    """
    import jax.custom_batching

    def call(spec, Sigma0):
        return fused_gains(spec, Sigma0, horizon=horizon, interpret=interpret)

    cv = jax.custom_batching.custom_vmap(call)

    @cv.def_vmap
    def _rule(axis_size, in_batched, spec, Sigma0):
        B = axis_size

        def fold(x, b):
            if not b:
                x = jnp.broadcast_to(x[None], (B,) + x.shape)
            return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])

        spec_f = jax.tree.map(fold, spec, in_batched[0])
        S0_f = fold(Sigma0, in_batched[1])
        L, H, K = cv(spec_f, S0_f)          # (T, B*P, ...)

        def unfold(a):
            a = a.reshape((a.shape[0], B, -1) + a.shape[2:])
            return jnp.moveaxis(a, 1, 0)    # (B, T, P, ...)

        return (unfold(L), unfold(H), unfold(K)), (True, True, True)

    return cv


def _require_zero_affine_costs(spec: LQGSpec):
    """Best-effort precondition check: the fused kernel (and its analytic
    adjoint, which emits hard-zero cotangents for these fields) ignores the
    affine/cross cost terms ``q, qf, P, r`` - they MUST be structurally
    zero, or both the primal gains and their gradients are silently wrong.

    Raises on provably nonzero concrete values; tracers (already inside an
    outer jit) cannot be inspected and remain the caller's responsibility -
    ``System._fused_ok`` performs the concrete check before dispatch.
    """
    import numpy as np

    for name in ("q", "qf", "P", "r"):
        x = getattr(spec, name)
        nonzero = False
        if isinstance(x, np.ndarray):
            nonzero = bool(x.any())
        else:
            try:
                nonzero = bool(jnp.any(x))
            except (jax.errors.TracerBoolConversionError,
                    jax.errors.ConcretizationTypeError):
                continue  # tracer: documented precondition, not checkable
        if nonzero:
            raise ValueError(
                f"fused gains kernel requires structurally-zero affine/cross "
                f"cost terms, but spec.{name} is nonzero; use the scan path "
                f"(System.gains(method='scan')) for affine-cost problems")


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def gains_fused(spec: LQGSpec, Sigma0: jnp.ndarray, horizon: int,
                interpret: bool = False):
    """Differentiable fused gains: kernel forward, analytic-adjoint backward.

    Precondition: the affine/cross cost terms ``q, qf, P, r`` must be
    structurally zero - the kernel ignores them in the forward pass and the
    analytic adjoint emits hard-zero cotangents for them.  Concretely
    nonzero values raise; tracer values are trusted (see
    :func:`_require_zero_affine_costs` and ``System._fused_ok``).

    The VJP runs :func:`_gains_adjoint_call` (forward kernel with stores,
    then the adjoint kernel), so ``jax.grad`` through a fused-gains
    likelihood matches differentiating the scan twin to f32 rounding.
    Both directions are vmap-aware: mapped axes fold into the particle
    batch.

    Same contract as :func:`fused_gains` (batched stationary spec).
    """
    _require_zero_affine_costs(spec)
    return _gains_fwd_cv(horizon, interpret)(spec, Sigma0)


@functools.lru_cache(maxsize=None)
def _gains_adj_cv(horizon: int, interpret: bool):
    """custom_vmap wrapper for the adjoint kernel call: mapped axes (NUTS
    chains vmapped over the potential's VJP) fold into the particle axis,
    mirroring :func:`_gains_fwd_cv` on the forward side."""
    import jax.custom_batching

    def call(spec, Sigma0, Lbar, Hbar, Kbar):
        return _gains_adjoint_call(spec, Sigma0, horizon, Lbar, Hbar, Kbar,
                                   interpret=interpret)

    cv = jax.custom_batching.custom_vmap(call)

    @cv.def_vmap
    def _rule(axis_size, in_batched, spec, Sigma0, Lbar, Hbar, Kbar):
        B = axis_size

        def fold_b(x, b):
            # batch-leading leaves (spec fields, Sigma0): (B, P, ...)->(B*P,)
            if not b:
                x = jnp.broadcast_to(x[None], (B,) + x.shape)
            return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])

        def fold_t(x, b):
            # time-leading cotangents: (B, T, P, ...) -> (T, B*P, ...)
            if not b:
                x = jnp.broadcast_to(x[None], (B,) + x.shape)
            x = jnp.moveaxis(x, 0, 1)
            return x.reshape((x.shape[0], x.shape[1] * x.shape[2])
                             + x.shape[3:])

        sb, cb = in_batched[0], in_batched[1]
        spec_f = jax.tree.map(fold_b, spec, sb)
        S0_f = fold_b(Sigma0, cb)
        Lf = fold_t(Lbar, in_batched[2])
        Hf = fold_t(Hbar, in_batched[3])
        Kf = fold_t(Kbar, in_batched[4])
        spec_bar, S0_bar = cv(spec_f, S0_f, Lf, Hf, Kf)

        def unfold(x):
            return x.reshape((B, -1) + x.shape[1:])

        out = (jax.tree.map(unfold, spec_bar), unfold(S0_bar))
        out_batched = (jax.tree.map(lambda _: True, spec_bar), True)
        return out, out_batched

    return cv


def _gains_fused_fwd(spec, Sigma0, horizon, interpret):
    _require_zero_affine_costs(spec)
    return _gains_fwd_cv(horizon, interpret)(spec, Sigma0), (spec, Sigma0)


def _gains_fused_bwd(horizon, interpret, res, cotangents):
    spec, Sigma0 = res
    Lbar, Hbar, Kbar = cotangents
    return _gains_adj_cv(horizon, interpret)(spec, Sigma0, Lbar, Hbar, Kbar)


gains_fused.defvjp(_gains_fused_fwd, _gains_fused_bwd)


def fused_gains_available(spec: LQGSpec) -> bool:
    """Kernel scope check: stationary spec, small dims, square noise mats.

    n <= 4 covers the zoo's in-scope actors (n = 2, 3, 4); the kernels
    unroll ~n^3 operations per step, and their GPU compile grows with it
    (14 s at n = 3, 80 s at n = 4 for value+grad, PERF.md)."""
    if spec.A.ndim != spec.Qf.ndim:  # stacked
        return False
    n = spec.A.shape[-1]
    m = spec.B.shape[-1]
    p = spec.F.shape[-2]
    return (n <= 4 and m <= 2 and p <= 3
            and spec.V.shape[-1] == n and spec.W.shape[-1] == p)


def _padded(Bn: int, lanes: int) -> int:
    return -(-Bn // lanes) * lanes


def _rows_const(x, Bp, r, c):
    # (B, r, c) -> (r*c, Bp), edge-padded particles
    Bn = x.shape[0]
    flat = jnp.moveaxis(x.reshape(Bn, r * c), 0, -1)
    if Bp != Bn:
        flat = jnp.pad(flat, ((0, 0), (0, Bp - Bn)), mode="edge")
    return flat


def _rows_sched(x, Bp, r, c):
    # (T, B, r, c) -> (T, r*c, Bp), zero-padded particles
    T, Bn = x.shape[:2]
    flat = jnp.moveaxis(x.reshape(T, Bn, r * c), 1, -1)
    if Bp != Bn:
        flat = jnp.pad(flat, ((0, 0), (0, 0), (0, Bp - Bn)))
    return flat


def _noise_covs(spec: LQGSpec):
    mT_ = lambda M: jnp.swapaxes(M, -1, -2)
    with jax.default_matmul_precision("highest"):
        return spec.V @ mT_(spec.V), spec.W @ mT_(spec.W)


@functools.partial(jax.jit,
                   static_argnames=("horizon", "with_stores", "eps",
                                    "interpret", "lanes", "num_warps"))
def fused_gains(spec: LQGSpec, Sigma0: jnp.ndarray, horizon: int,
                eps: float = 1e-12, with_stores: bool = False,
                interpret: bool = False, lanes: int = LANES,
                num_warps: int = NUM_WARPS):
    """Fused gain schedules for a batch of stationary specs.

    Args:
        spec: batched stationary spec; leading axis B (particles).
        Sigma0: (B, n, n) initial covariance.
        horizon: T.
        with_stores: additionally return the per-step recursion carries
            (Riccati ``S_t``, Kalman ``P_t``) in the raw lane layout - the
            residues of the analytic adjoint kernel (internal; see
            :func:`_gains_adjoint_call`).
        interpret: run in the Pallas interpreter instead of compiling.
        lanes, num_warps: particles and warps per program.

    Returns:
        ``(L, H, K)`` with shapes ``(T, B, m, n)``, ``(T, B, m, m)``,
        ``(T, B, n, p)`` - matching :func:`lqg_tpu.ops.riccati.backward` /
        :func:`lqg_tpu.ops.kalman.forward` (with ``regularize="none"``).
        With ``with_stores``: ``(L, H, K, (S_raw, P_raw))``.
    """
    Bn = spec.A.shape[0]
    n = spec.A.shape[-1]
    m = spec.B.shape[-1]
    p = spec.F.shape[-2]
    T = horizon
    dtype = spec.A.dtype
    Bp = _padded(Bn, lanes)
    rows = lambda x, r, c: _rows_const(x, Bp, r, c)
    VV, WW = _noise_covs(spec)

    def in_spec(r):
        return pl.BlockSpec((r, lanes), lambda b: (0, b))

    def out_spec(r):
        return pl.BlockSpec((T, r, lanes), lambda b: (0, 0, b))

    sizes = [m * n, m * m, n * p] + ([n * n, n * n] if with_stores else [])
    outs = pallas_gpu_call(
        functools.partial(_gains_kernel, n=n, m=m, p=p, T=T, eps=eps,
                          emit_stores=with_stores),
        grid=(Bp // lanes,),
        in_specs=[in_spec(n * n), in_spec(n * m), in_spec(n * n),
                  in_spec(m * m), in_spec(n * n), in_spec(p * n),
                  in_spec(n * n), in_spec(p * p), in_spec(n * n)],
        out_specs=tuple(out_spec(r) for r in sizes),
        out_shape=tuple(jax.ShapeDtypeStruct((T, r, Bp), dtype)
                        for r in sizes),
        interpret=interpret, num_warps=num_warps, name="lqg_gains",
    )(rows(spec.A, n, n), rows(spec.B, n, m), rows(spec.Q, n, n),
      rows(spec.R, m, m), rows(spec.Qf, n, n), rows(spec.F, p, n),
      rows(VV, n, n), rows(WW, p, p), rows(Sigma0, n, n))

    def unrows(x, r, c):
        # (T, r*c, Bp) -> (T, B, r, c)
        return jnp.moveaxis(x[..., :Bn], -1, 1).reshape(T, Bn, r, c)

    res = (unrows(outs[0], m, n), unrows(outs[1], m, m),
           unrows(outs[2], n, p))
    if with_stores:
        return res + ((outs[3], outs[4]),)
    return res


@functools.partial(jax.jit, static_argnames=("horizon", "eps", "interpret"))
def _gains_adjoint_call(spec: LQGSpec, Sigma0, horizon: int,
                        Lbar, Hbar, Kbar, eps: float = 1e-12,
                        interpret: bool = False):
    """Analytic gains VJP: re-run the forward kernel with stores, then one
    adjoint kernel launch.  Returns ``(spec_bar, Sigma0_bar)``.

    Cotangents ``Lbar/Hbar/Kbar`` are shaped like :func:`fused_gains`
    outputs ``(T, B, ...)``.
    """
    Bn = spec.A.shape[0]
    n = spec.A.shape[-1]
    m = spec.B.shape[-1]
    p = spec.F.shape[-2]
    T = horizon
    dtype = spec.A.dtype

    _, _, _, (S_raw, P_raw) = fused_gains(
        spec, Sigma0, horizon, with_stores=True, eps=eps,
        interpret=interpret)

    lanes = LANES
    Bp = _padded(Bn, lanes)
    rows = lambda x, r, c: _rows_const(x, Bp, r, c)
    rows_t = lambda x, r, c: _rows_sched(x, Bp, r, c)
    VV, WW = _noise_covs(spec)

    def in_spec(r):
        return pl.BlockSpec((r, lanes), lambda b: (0, b))

    def in_spec_t(r):
        return pl.BlockSpec((T, r, lanes), lambda b: (0, 0, b))

    shapes = [(n, n), (n, m), (n, n), (m, m), (n, n), (p, n), (n, n),
              (p, p), (n, n)]
    outs = pallas_gpu_call(
        functools.partial(_gains_adjoint_kernel, n=n, m=m, p=p, T=T,
                          eps=eps),
        grid=(Bp // lanes,),
        in_specs=[in_spec(n * n), in_spec(n * m), in_spec(m * m),
                  in_spec(p * n), in_spec(n * n), in_spec(p * p),
                  in_spec_t(n * n), in_spec_t(n * n),
                  in_spec_t(m * n), in_spec_t(m * m), in_spec_t(n * p)],
        out_specs=tuple(in_spec(a * b) for a, b in shapes),
        out_shape=tuple(jax.ShapeDtypeStruct((a * b, Bp), dtype)
                        for a, b in shapes),
        interpret=interpret, num_warps=NUM_WARPS, name="lqg_gains_adjoint",
    )(rows(spec.A, n, n), rows(spec.B, n, m), rows(spec.R, m, m),
      rows(spec.F, p, n), rows(VV, n, n), rows(WW, p, p),
      S_raw, P_raw,
      rows_t(Lbar, m, n), rows_t(Hbar, m, m), rows_t(Kbar, n, p))

    def unrows(x, a, b):
        return jnp.moveaxis(x[:, :Bn], -1, 0).reshape(Bn, a, b)

    (Abar, Bbar, Qbar, Rbar, Qfbar, Fbar, VVbar, WWbar,
     S0bar) = (unrows(o, a, b) for o, (a, b) in zip(outs, shapes))

    mT_ = lambda M: jnp.swapaxes(M, -1, -2)
    # chain VV = V V^T, WW = W W^T back to the noise-scale matrices
    with jax.default_matmul_precision("highest"):
        Vbar = (VVbar + mT_(VVbar)) @ spec.V
        Wbar = (WWbar + mT_(WWbar)) @ spec.W

    # canonical gauge: the cotangents of the symmetric-matrix inputs
    # (Q, Qf, R, Sigma0) are only determined up to their asymmetric part
    # (the recursions are specified on the symmetric manifold; all
    # constructors produce symmetric tangents, e.g. d(V V^T) and d(c*I))
    # - emit the symmetric representative, matching the scan twin (whose
    # symmetrize()/cholesky ops project these cotangents)
    sym = lambda M: 0.5 * (M + mT_(M))
    Qbar, Qfbar, Rbar, S0bar = sym(Qbar), sym(Qfbar), sym(Rbar), sym(S0bar)

    def zlike(x):
        return jnp.zeros(jnp.shape(x), dtype=dtype)

    spec_bar = LQGSpec(
        Q=Qbar, q=zlike(spec.q), Qf=Qfbar, qf=zlike(spec.qf),
        P=zlike(spec.P), R=Rbar, r=zlike(spec.r),
        A=Abar, B=Bbar, V=Vbar, F=Fbar, W=Wbar)
    return spec_bar, S0bar
