"""Convergence + science report for a data.mat posterior artifact.

Loads ``data/processed/{model}-{seed}.nc``, prints the full diagnostic
table (split-R-hat, Geyer ESS), and quantifies the eLife headline result:
per-condition sensory noise ``sigma_target_i`` rising with the target blob
width (Bonnen et al. 2015 stimuli; Straub & Rothkopf 2022 fig. 4-style
trend).  Reference workflow: ``/root/reference/notebooks/Data.ipynb``
(plots per-condition posterior means against blob widths; its committed
artifacts are stripped from the snapshot, so the trend itself is the
comparison target).

Usage: python scripts/analyze_fit.py data/processed/BoundedActor-1.nc
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(path):
    from lqg_tpu.io import load_tracking_data
    from lqg_tpu.infer.diagnostics import format_summary, summary
    from lqg_tpu.results import load_netcdf

    samples = load_netcdf(path)
    table = summary(samples)
    print(f"== {path} ==")
    print(format_summary(table))

    rhat = max(row["r_hat"] for row in table.values())
    ess = min(row["n_eff"] for row in table.values())
    print(f"\nmax r_hat = {rhat:.4f}   min ESS = {ess:.0f}")

    _, bws = load_tracking_data(delay=12, clip=180, subtract_mean=False)
    st = [f"sigma_target_{i}" for i in range(6)]
    if all(s in samples for s in st):
        means = np.array([np.mean(samples[s]) for s in st])
        q5 = np.array([np.quantile(samples[s], 0.05) for s in st])
        q95 = np.array([np.quantile(samples[s], 0.95) for s in st])
        print("\nblob width (arcmin) vs posterior sigma_target:")
        for w, m, a, b in zip(bws, means, q5, q95):
            print(f"  {w:7.2f}  ->  {m:7.2f}  [{a:7.2f}, {b:7.2f}]")
        from scipy.stats import spearmanr

        rho, _ = spearmanr(bws, means)
        slope = np.polyfit(np.log(np.asarray(bws, float)),
                           np.log(means), 1)[0]
        print(f"\nsigma_target vs blob width: Spearman rho = {rho:.3f}, "
              f"log-log slope = {slope:.3f} "
              f"(eLife trend: monotone increase, rho = 1)")
    return df


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else "data/processed/BoundedActor-1.nc")
