"""Posterior result persistence: netcdf + CSV artifacts, run checkpoints.

The reference persists posteriors as arviz netcdf (``cpp_data_fit.py:54-55``)
and CSV summaries (``main.py:80-84``).  This module writes the same artifact
shapes without the arviz dependency (scipy's netcdf writer + csv), and
adds checkpoint/resume for long MCMC runs (SURVEY.md section 5.4 - a
capability the reference lacks).
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np


def save_netcdf(path: str, samples: dict, attrs: dict | None = None):
    """Write posterior samples to a classic netcdf file.

    ``samples``: dict name -> (chains, draws) array.  Layout matches the
    arviz convention (``chain``/``draw`` dimensions, posterior group
    flattened into top-level variables).
    """
    from scipy.io import netcdf_file

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    first = next(iter(samples.values()))
    arr = np.asarray(first)
    if arr.ndim == 1:
        samples = {k: np.asarray(v)[None] for k, v in samples.items()}
        arr = arr[None]
    chains, draws = np.asarray(arr).shape[:2]

    with netcdf_file(path, "w") as f:
        f.createDimension("chain", chains)
        f.createDimension("draw", draws)
        for name, vals in samples.items():
            v = f.createVariable(name, "d", ("chain", "draw"))
            v[:] = np.asarray(vals, dtype=np.float64)
        for k, val in (attrs or {}).items():
            setattr(f, k, str(val))


def load_netcdf(path: str) -> dict:
    from scipy.io import netcdf_file

    out = {}
    with netcdf_file(path, "r") as f:
        for name, var in f.variables.items():
            out[name] = np.array(var[:])
    return out


def save_summary_csv(path: str, summary: dict, true_params: dict | None = None,
                     seed=None):
    """Write a parameter-recovery CSV like the reference CLI
    (``main.py:80-84``).

    ``summary``: ``{name: {column: value}}`` as from
    :func:`lqg_tpu.infer.diagnostics.summary`.  Adds a ``true`` column from
    ``true_params`` and a ``seed`` column; returns the rows written.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rows = {name: dict(row) for name, row in summary.items()}
    for key, val in (true_params or {}).items():
        if key in rows:
            rows[key]["true"] = float(val)
    if seed is not None:
        for row in rows.values():
            row["seed"] = seed
    columns = list(dict.fromkeys(c for row in rows.values() for c in row))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([""] + columns)
        for name, row in rows.items():
            writer.writerow([name] + [row.get(c, "") for c in columns])
    return rows


def save_mcmc_checkpoint(path: str, mcmc):
    """Persist an MCMC run (unconstrained draws + extra fields + model
    names) for resume/re-analysis."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    extra = {k: np.asarray(v) for k, v in mcmc.get_extra_fields().items()}
    np.savez_compressed(
        path,
        samples_u=np.asarray(mcmc._samples_u),
        names=np.array(mcmc.model.names),
        **{f"extra_{k}": v for k, v in extra.items()},
    )


def load_mcmc_checkpoint(path: str, mcmc):
    """Restore draws/extras into an MCMC object built with the same model."""
    data = np.load(path, allow_pickle=False)
    names = [str(n) for n in data["names"]]
    if names != list(mcmc.model.names):
        raise ValueError(f"model parameter mismatch: {names} vs "
                         f"{mcmc.model.names}")
    mcmc._samples_u = data["samples_u"]
    mcmc._extra = {k[len("extra_"):]: data[k] for k in data.files
                   if k.startswith("extra_")}
    return mcmc
