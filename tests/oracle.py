"""Independent NumPy (float64) oracle implementations.

These are straight-line, per-step NumPy transcriptions of the LQG math - the
generalized Riccati backward recursion, the Kalman covariance forward pass,
and the condition/marginalize likelihood recursion - used as the correctness
anchor for the batched kernels (SURVEY.md section 4: "parity tests against small
NumPy reference implementations").
"""

import numpy as np


def lqr_backward(Q, q, Qf, qf, P, R, r, A, B, eps=1e-8):
    """Generalized Riccati backward pass.  All inputs time-stacked (T, ...)."""
    T = A.shape[0]
    n = A.shape[1]
    m = B.shape[2]
    L = np.zeros((T, m, n))
    l = np.zeros((T, m))
    S, s = Qf.copy(), qf.copy()
    for t in range(T - 1, -1, -1):
        H = R[t] + B[t].T @ S @ B[t]
        G = P[t] + B[t].T @ S @ A[t]
        g = r[t] + B[t].T @ s
        evals = np.linalg.eigvalsh(H)
        Ht = H + max(0.0, eps - evals[0]) * np.eye(m)
        L[t] = -np.linalg.solve(Ht, G)
        l[t] = -np.linalg.solve(Ht, g)
        S = Q[t] + A[t].T @ S @ A[t] + L[t].T @ H @ L[t] + L[t].T @ G + G.T @ L[t]
        s = q[t] + A[t].T @ s + G.T @ l[t] + L[t].T @ H @ l[t] + L[t].T @ g
    return L, l


def kf_forward(A, F, V, W, Sigma0):
    """Kalman covariance recursion producing the gain schedule."""
    T = A.shape[0]
    n = A.shape[1]
    p = F.shape[1]
    K = np.zeros((T, n, p))
    Pcov = Sigma0.copy()
    for t in range(T):
        Pcov = A[t] @ Pcov @ A[t].T + V[t] @ V[t].T
        G = F[t] @ Pcov @ F[t].T + W[t] @ W[t].T
        K[t] = Pcov @ F[t].T @ np.linalg.inv(G)
        Pcov = (np.eye(n) - K[t] @ F[t]) @ Pcov
    return K


def joint_system(A_d, B_d, F_d, V_d, W_d, A_a, B_a, F_a, L, K):
    """Joint (state, belief) transition and noise factor, per timestep."""
    T = A_d.shape[0]
    x = A_d.shape[1]
    b = A_a.shape[1]
    Fs, Gs = [], []
    for t in range(T):
        BL = B_d[t] @ L[t]
        top = np.hstack([A_d[t], BL])
        bot = np.hstack([
            K[t] @ F_d[t] @ A_d[t],
            A_a[t] + B_a[t] @ L[t] - K[t] @ F_a[t] @ A_a[t]
            + K[t] @ (F_d[t] @ B_d[t] - F_a[t] @ B_a[t]) @ L[t],
        ])
        Fs.append(np.vstack([top, bot]))
        g_top = np.hstack([V_d[t], np.zeros((x, W_d.shape[2]))])
        g_bot = np.hstack([K[t] @ F_d[t] @ V_d[t], K[t] @ W_d[t]])
        Gs.append(np.vstack([g_top, g_bot]))
    return np.stack(Fs), np.stack(Gs)


def conditional_moments(Fj, Gj, x):
    """Condition-on-data / marginalize recursion for ONE trial.

    x: (T+1, d).  Returns mu (T, j), Sigma (T, j, j) for t = 1..T.
    """
    T = Fj.shape[0]
    j = Fj.shape[1]
    d = x.shape[1]
    mu = np.concatenate([x[0], np.zeros(j - d)])
    Sigma = Gj[0] @ Gj[0].T
    mus, Sigmas = [], []
    for t in range(T):
        F, G = Fj[t], Gj[t]
        S = Sigma[:d, :d]
        innov = x[t] - mu[:d]
        mu = F @ mu + (F @ Sigma)[:, :d] @ np.linalg.solve(S, innov)
        Sigma = (F @ Sigma @ F.T + G @ G.T
                 - (F @ Sigma)[:, :d] @ np.linalg.solve(S, (Sigma @ F.T)[:d, :]))
        mus.append(mu.copy())
        Sigmas.append(Sigma.copy())
    return np.stack(mus), np.stack(Sigmas)


def log_likelihood(Fj, Gj, x):
    """Marginal log likelihood of x[1:] for ONE trial (sum over time)."""
    mu, Sigma = conditional_moments(Fj, Gj, x)
    d = x.shape[1]
    # mu[t] / Sigma[t] are the moments of x_{t+1} | x_{0:t}; score x[t+1]
    total = 0.0
    for t in range(mu.shape[0]):
        m = mu[t, :d]
        # Sigma[t][:d,:d] is the covariance of x_{t+1} | x_{0:t}
        S = Sigma[t, :d, :d]
        diff = x[t + 1] - m
        sign, logdet = np.linalg.slogdet(2 * np.pi * S)
        total += -0.5 * (diff @ np.linalg.solve(S, diff) + logdet)
    return total
