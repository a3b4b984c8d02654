"""MCMC convergence diagnostics: split-R-hat, effective sample size, summary.

Native replacements for the arviz summaries the reference leans on
(``main.py:71-77``).  Implements the standard split-chain potential scale
reduction factor and Geyer initial-positive-sequence ESS.
"""

from __future__ import annotations

import numpy as np


def _split_chains(x):
    """(chains, draws) -> (2*chains, draws//2)."""
    c, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, n - half:]], axis=0)


def split_rhat(x) -> float:
    """Split-chain R-hat for one scalar parameter; x: (chains, draws)."""
    x = _split_chains(np.asarray(x, dtype=np.float64))
    m, n = x.shape
    if n < 2:
        return np.nan
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = n * chain_means.var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * W + B / n
    if W <= 0:
        return np.nan
    return float(np.sqrt(var_plus / W))


def ess(x) -> float:
    """Effective sample size via FFT autocorrelation + Geyer truncation.

    x: (chains, draws).
    """
    x = _split_chains(np.asarray(x, dtype=np.float64))
    m, n = x.shape
    if n < 4:
        return float(m * n)

    # per-chain autocovariance via FFT
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :n].real
    acov = acov / n

    chain_var = acov[:, 0] * n / (n - 1.0)
    W = chain_var.mean()
    var_plus = acov[:, 0].mean() * n / (n - 1.0)
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0 or W <= 0:
        return float(m * n)

    # Geyer's initial monotone positive sequence on paired sums:
    # tau = -1 + 2 * sum_k P_k,  P_k = rho_{2k} + rho_{2k+1}
    rho = 1.0 - (W - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0
    n_pairs = n // 2
    pair = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]

    s = 0.0
    prev = np.inf
    for k in range(len(pair)):
        p = min(pair[k], prev)
        if p < 0:
            break
        s += p
        prev = p
    tau = max(-1.0 + 2.0 * s, 1.0 / np.log10(max(m * n, 10)))
    return float(min(m * n / tau, m * n * np.log10(max(m * n, 10))))


_COLUMNS = ("mean", "sd", "median", "q5", "q95", "n_eff", "r_hat")


def summary(samples: dict, group_by_chain=True) -> dict:
    """Posterior summary table.

    ``samples``: dict name -> (chains, draws) (or (draws,) when
    ``group_by_chain=False``).  Returns ``{name: {column: float}}`` with
    columns mean, sd, median, q5, q95, n_eff and r_hat (split-R-hat).
    """
    rows = {}
    for name, vals in samples.items():
        v = np.asarray(vals, dtype=np.float64)
        if not group_by_chain or v.ndim == 1:
            v = v.reshape(1, -1)
        flat = v.reshape(-1)
        rows[name] = dict(
            mean=float(flat.mean()),
            sd=float(flat.std(ddof=1)) if flat.size > 1 else np.nan,
            median=float(np.median(flat)),
            q5=float(np.quantile(flat, 0.05)),
            q95=float(np.quantile(flat, 0.95)),
            n_eff=ess(v),
            r_hat=split_rhat(v),
        )
    return rows


def format_summary(table: dict) -> str:
    """Render a :func:`summary` table as aligned text, one row per
    parameter."""
    width = max([len(n) for n in table] + [4])
    lines = [" " * width + "".join(f"{c:>10s}" for c in _COLUMNS)]
    for name, row in table.items():
        lines.append(f"{name:<{width}s}"
                     + "".join(f"{row[c]:10.3f}" for c in _COLUMNS))
    return "\n".join(lines)
