"""MCMC driver: warmup-adapted NUTS over vmapped chains.

Replaces the reference's NumPyro ``MCMC(NUTS(...))`` stack
(``lqg/infer/utils.py:14-39``) with a native, fully jittable driver:

* warmup adaptation + sampling compile to ONE chunk program (adaptation
  gated by per-step flags indexed by an on-device step counter) that is
  re-launched in segments, with chains ``vmap``-ed as a batch axis, not
  processes (the reference dispatches chains over host devices,
  ``numpyro.set_host_device_count(4)`` at ``main.py:8``);
* each launch carries a *leapfrog budget*: the compiled chunk runs up to
  ``chunk_steps`` NUTS transitions but stops early once the batched
  leapfrog count (max over chains - vmapped tree loops run to the deepest
  chain) exceeds ``max_leapfrogs_per_launch``.  This bounds per-launch
  device time regardless of tree depth while letting shallow-tree phases
  run many transitions per dispatch;
* early-warmup tree depth is capped by a per-step schedule (traced
  ``depth_cap`` into :func:`nuts_step`), so a bad initial step size cannot
  burn ``2^max_depth`` leapfrogs per step while dual averaging is still
  finding the scale;
* on a device mesh, chains shard over devices: the chain-batched programs
  run under ``shard_map``, so each device runs its own chains (see
  :mod:`lqg_tpu.parallel`).
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, random

from lqg_tpu.infer import adaptation as adapt
from lqg_tpu.infer.hmc import nuts_step
from lqg_tpu.infer.models import ProbModel


class ChainState(NamedTuple):
    z: jnp.ndarray
    pe: jnp.ndarray
    grad: jnp.ndarray
    step_size: jnp.ndarray
    inv_mass: jnp.ndarray
    da: adapt.DualAveragingState
    welford: adapt.WelfordState
    rng_key: jnp.ndarray


class MCMC:
    """Run NUTS on a :class:`ProbModel`.

    Args:
        model: the probabilistic model (potential + transforms).
        num_warmup / num_samples: warmup and kept draws per chain.
        num_chains: chains, run as a vmapped batch axis.
        max_depth: NUTS maximum tree depth.
        target_accept: dual-averaging target acceptance probability.
        thinning: keep every k-th sample.
        dense_mass: adapt a DENSE inverse-mass matrix (full posterior
            covariance, Stan's dense metric) instead of a diagonal one.
            Default ``None`` = auto: dense for 2 <= zdim <= 64.  Linearly
            correlated posteriors (e.g. the hierarchical data.mat fit)
            drive every NUTS tree to max depth under a diagonal metric;
            the dense metric whitens them.
        init_inv_mass: start from this inverse mass instead of identity -
            ``(zdim,)`` variances or ``(zdim, zdim)`` lower-Cholesky of the
            posterior covariance.  Empirical preconditioning: feed a
            previous run's (even poorly mixed) draw covariance back in.
        adapt_mass: set False to keep ``init_inv_mass`` fixed (warmup then
            adapts the step size only) - windowed re-estimation would
            overwrite a good externally supplied metric with one made from
            autocorrelated early draws.
        chunk_steps: max NUTS transitions per device launch (one compiled
            program, re-launched until done).
        max_leapfrogs_per_launch: stop a launch early once this many
            batched leapfrogs have run (device-time bound; see module doc).
        warmup_depth_cap / warmup_depth_cap_steps: cap tree depth at
            ``warmup_depth_cap`` for the first ``warmup_depth_cap_steps``
            warmup transitions (adaptation-only; kept draws are never
            capped below ``max_depth``).
        checkpoint_every: launches between checkpoint writes when
            ``checkpoint_path`` is given (default: roughly every 128
            steps); draws are buffered on host in between.
    """

    def __init__(self, model: ProbModel, num_warmup: int = 1000,
                 num_samples: int = 1000, num_chains: int = 1,
                 max_depth: int = 10, target_accept: float = 0.8,
                 init_jitter: float = 0.2, thinning: int = 1,
                 progress: bool = False, chunk_steps: Optional[int] = None,
                 max_leapfrogs_per_launch: Optional[int] = None,
                 warmup_depth_cap: int = 7,
                 warmup_depth_cap_steps: int = 75,
                 checkpoint_every: Optional[int] = None,
                 dense_mass: Optional[bool] = None,
                 init_inv_mass=None, adapt_mass: bool = True):
        self.model = model
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.num_chains = num_chains
        self.max_depth = max_depth
        self.target_accept = target_accept
        self.init_jitter = init_jitter
        self.thinning = thinning
        self.progress = progress
        # Launch sizing, the same on every backend: up to 64 transitions
        # per launch and no leapfrog budget unless the caller sets one.
        if chunk_steps is None:
            chunk_steps = 64
        self.chunk_steps = max(1, int(chunk_steps))
        if max_leapfrogs_per_launch is None:
            max_leapfrogs_per_launch = 1 << 30
        self.max_leapfrogs_per_launch = int(max_leapfrogs_per_launch)
        self.warmup_depth_cap = int(warmup_depth_cap)
        self.warmup_depth_cap_steps = int(warmup_depth_cap_steps)
        self.checkpoint_every = checkpoint_every
        self.dense_mass = dense_mass
        self.init_inv_mass = (None if init_inv_mass is None
                              else jnp.asarray(init_inv_mass))
        self.adapt_mass = adapt_mass
        self._dense = False  # resolved against zdim in run()
        self._samples_u = None
        self._extra = None

    # --- chain programs ---
    def _init_chain(self, rng_key, z0):
        potential = self.model.potential
        zdim = z0.shape[0]

        key_init, key_ss, key_run = random.split(rng_key, 3)

        pe0, grad0 = jax.value_and_grad(potential)(z0)
        if self.init_inv_mass is not None:
            inv_mass0 = self.init_inv_mass
        else:
            inv_mass0 = jnp.eye(zdim) if self._dense else jnp.ones(zdim)
        step0 = adapt.find_reasonable_step_size(
            potential, inv_mass0, z0, pe0, grad0, key_ss)

        return ChainState(
            z=z0, pe=pe0, grad=grad0,
            step_size=step0, inv_mass=inv_mass0,
            da=adapt.da_init(step0),
            welford=adapt.welford_init(zdim, dense=self._dense),
            rng_key=key_run,
        )

    def _step_one(self, state: ChainState, inp, depth_cap):
        """One NUTS transition + adaptation for a single chain.  ``inp``
        holds the (scalar, shared across chains) warmup-schedule flags."""
        potential = self.model.potential
        zdim = state.z.shape[0]
        is_warmup, in_win, win_end, freeze = inp

        key, sub = random.split(state.rng_key)
        z, pe, grad, info = nuts_step(
            potential, sub, state.z, state.pe, state.grad,
            state.step_size, state.inv_mass, max_depth=self.max_depth,
            depth_cap=depth_cap)

        # --- adaptation (warmup only) ---
        da = adapt.da_update(state.da, info.accept_prob,
                             target=self.target_accept)
        da = jax.tree.map(lambda new, old: jnp.where(is_warmup, new, old),
                          da, state.da)
        step_size = jnp.where(is_warmup, jnp.exp(da.log_step),
                              state.step_size)

        welford = jax.tree.map(
            lambda old, new: jnp.where(in_win, new, old),
            state.welford, adapt.welford_update(state.welford, z))

        # close a slow window: adopt the variance/covariance as inverse
        # mass, reset the accumulator and restart dual averaging
        new_mass = adapt.welford_mass(welford)
        inv_mass = jnp.where(win_end, new_mass, state.inv_mass)
        da_reset = adapt.da_init(jnp.exp(da.log_step_avg))
        da = jax.tree.map(lambda r, c: jnp.where(win_end, r, c),
                          da_reset, da)
        welford = jax.tree.map(
            lambda w, fresh: jnp.where(win_end, fresh, w),
            welford, adapt.welford_init(zdim, dense=self._dense))
        step_size = jnp.where(win_end, jnp.exp(da.log_step), step_size)

        # end of warmup: freeze the dual-averaged step size
        step_size = jnp.where(freeze, jnp.exp(da.log_step_avg), step_size)

        new_state = ChainState(z=z, pe=pe, grad=grad,
                               step_size=step_size, inv_mass=inv_mass,
                               da=da, welford=welford, rng_key=key)
        out = (z, info.accept_prob, info.diverging, info.num_steps,
               info.tree_depth, pe)
        return new_state, out

    def _build_schedule(self, total):
        """Host-side per-step flag and depth-cap arrays for the full run."""
        in_window, window_end = adapt.build_schedule(self.num_warmup)
        is_warmup = np.arange(total) < self.num_warmup
        freeze = np.arange(total) == (self.num_warmup - 1)
        in_win = np.zeros(total, dtype=bool)
        in_win[:self.num_warmup] = np.asarray(in_window)
        win_end = np.zeros(total, dtype=bool)
        win_end[:self.num_warmup] = np.asarray(window_end)
        flags = np.stack([is_warmup, in_win, win_end, freeze], axis=1)

        if not self.adapt_mass:
            flags[:, 1] = False   # never accumulate
            flags[:, 2] = False   # never adopt a new mass
        caps = np.full(total, self.max_depth, dtype=np.int32)
        n_cap = min(self.warmup_depth_cap_steps, self.num_warmup)
        caps[:n_cap] = min(self.warmup_depth_cap, self.max_depth)
        return jnp.asarray(flags), jnp.asarray(caps)

    @staticmethod
    def _chain_map(fn, in_axes, chain_sharding):
        """``vmap`` over chains; with a chain sharding, inside ``shard_map``
        so every device runs only its own chains (the Pallas kernels are
        custom calls, which XLA's partitioner would otherwise replicate)."""
        mapped = jax.vmap(fn, in_axes=in_axes)
        if chain_sharding is None:
            return mapped
        from jax.sharding import PartitionSpec

        spec = chain_sharding.spec
        return jax.shard_map(
            mapped, mesh=chain_sharding.mesh,
            in_specs=tuple(spec if a == 0 else PartitionSpec()
                           for a in in_axes),
            out_specs=spec, check_vma=False)

    def _make_launch(self, total: int, chunk: int, chain_sharding=None):
        """Build the (jittable) one-launch program: up to ``chunk``
        transitions, stopping early at the leapfrog budget or run end."""
        budget = float(self.max_leapfrogs_per_launch)
        step_vmapped = self._chain_map(self._step_one, (0, None, None),
                                       chain_sharding)

        def launch(state, idx0, flags, caps):
            def body(carry, _):
                state, idx, lf = carry
                active = (idx < total) & (lf < budget)

                def do(op):
                    state, idx, lf = op
                    fl = flags[idx]
                    new_state, out = step_vmapped(
                        state, (fl[0], fl[1], fl[2], fl[3]), caps[idx])
                    # batched device cost per transition ~ deepest chain's
                    # tree (vmapped while_loops run to the max)
                    return new_state, idx + 1, lf + jnp.max(out[3]), out

                def skip(op):
                    state, idx, lf = op
                    zf = jnp.zeros_like(state.pe)
                    out = (jnp.zeros_like(state.z), zf,
                           jnp.zeros(state.pe.shape[0], bool), zf,
                           jnp.zeros(state.pe.shape[0], jnp.int32), zf)
                    return state, idx, lf, out

                state, idx, lf, out = lax.cond(active, do, skip,
                                               (state, idx, lf))
                return (state, idx, lf), (out, active)

            (state, idx, _), (outs, valid) = lax.scan(
                body, (state, idx0, jnp.zeros((), jnp.float32)),
                None, length=chunk)
            return state, idx, outs, valid

        return jax.jit(launch)

    def run(self, rng_key, checkpoint_path: Optional[str] = None,
            chain_sharding=None, _stop_after_launches: Optional[int] = None):
        """Run all chains; returns self for chaining.

        The run executes as a sequence of launches of one compiled chunk
        program (plus one init program); each launch advances as many NUTS
        transitions as fit in ``(chunk_steps, max_leapfrogs_per_launch)``
        and streams its draws back to host.

        Args:
            checkpoint_path: if given, the in-flight run state is written
                there every ``checkpoint_every`` launches (draws to
                nonce-stamped side files, chain state atomically replaced),
                and an existing compatible checkpoint at that path is
                resumed from instead of starting over.  Resume is exact:
                transitions are keyed by a global step index, so launch
                boundaries (and even a different ``chunk_steps``) do not
                change the sampled trajectory.  In multi-process runs the
                path must be on a filesystem shared by all processes
                (process 0 writes, every process reads on resume; a
                divergent read raises instead of deadlocking).
            chain_sharding: optional ``jax.sharding.Sharding`` for the chain
                axis; per-chain keys and initial positions are placed with
                it, so XLA partitions the whole warmup+sampling program SPMD
                over the mesh (used by
                :func:`lqg_tpu.parallel.sharding.sharded_chains_run`).
            _stop_after_launches: testing hook - stop (returning ``None``)
                after this many launches, leaving the checkpoint behind.
        """
        total = self.num_warmup + self.num_samples * self.thinning
        chunk = min(self.chunk_steps, total)
        flags, caps = self._build_schedule(total)

        ckpt_every = self.checkpoint_every
        if ckpt_every is None:
            ckpt_every = max(1, 128 // chunk)

        u0 = self.model.init_unconstrained()
        zdim = u0.shape[0]
        if self.init_inv_mass is not None:
            self._dense = self.init_inv_mass.ndim == 2
        else:
            self._dense = (self.dense_mass if self.dense_mass is not None
                           else 2 <= zdim <= 64)
        keys = random.split(rng_key, self.num_chains + 1)
        jitter = self.init_jitter * random.uniform(
            keys[0], (self.num_chains, u0.shape[0]), minval=-1.0, maxval=1.0)
        z0 = u0[None, :] + jitter

        chain_keys = keys[1:]
        if chain_sharding is not None:
            chain_keys = jax.device_put(chain_keys, chain_sharding)
            z0 = jax.device_put(z0, chain_sharding)

        init_fn = jax.jit(self._chain_map(self._init_chain, (0, 0),
                                          chain_sharding))
        launch_fn = self._make_launch(total, chunk, chain_sharding)

        def to_host(a):
            # multi-process (jax.distributed) runs shard the chain axis
            # across processes: replicate before host transfer so every
            # process holds the full draws/state (needed for streaming
            # checkpoints and result assembly)
            if (chain_sharding is not None and isinstance(a, jax.Array)
                    and not a.is_fully_addressable):
                from jax.sharding import NamedSharding, PartitionSpec
                rep = NamedSharding(chain_sharding.mesh, PartitionSpec())
                a = jax.device_put(a, rep)
            return np.asarray(a)

        state = init_fn(chain_keys, z0)
        outs_host = []      # list of 6-tuples of (steps_k, chains, ...) arrays
        pending = []        # buffered since the last checkpoint write
        steps_done = 0
        n_files = 0
        nonce = np.uint64(int.from_bytes(os.urandom(8), "little"))
        if checkpoint_path is not None:
            resumed = self._load_run_checkpoint(checkpoint_path, state)
            if resumed is not None:
                state, outs_host, steps_done, nonce, n_files = resumed
                if chain_sharding is not None:
                    # restored leaves land on default placement; re-apply the
                    # chain sharding so resumed runs stay SPMD over the mesh
                    state = jax.tree.map(
                        lambda l: jax.device_put(l, chain_sharding), state)
                if self.progress:
                    print(f"[mcmc] resumed at step {steps_done}/{total} "
                          f"from {checkpoint_path}", flush=True)
            else:
                self._clean_orphan_chunks(checkpoint_path)
            if jax.process_count() > 1:
                # every process read checkpoint_path independently; if the
                # path is not on a shared filesystem the processes can take
                # divergent resume/fresh-start decisions and the subsequent
                # collectives deadlock.  Cross-check the resume step against
                # process 0 and fail loudly instead.
                from jax.experimental import multihost_utils

                p0_step = int(multihost_utils.broadcast_one_to_all(
                    np.int64(steps_done)))
                if p0_step != steps_done:
                    raise RuntimeError(
                        f"multi-process checkpoint resume diverged: process "
                        f"0 is at step {p0_step} but process "
                        f"{jax.process_index()} read step {steps_done} from "
                        f"{checkpoint_path}. checkpoint_path must be on a "
                        f"filesystem shared by all processes (process 0 "
                        f"writes, every process reads)")

        launches = 0
        while steps_done < total:
            state, idx, outs, valid = launch_fn(
                state, jnp.asarray(steps_done, jnp.int32), flags, caps)
            n_valid = int(to_host(valid).sum())
            host_out = tuple(to_host(o[:n_valid]) for o in outs)
            outs_host.append(host_out)
            pending.append(host_out)
            steps_done = int(idx)
            launches += 1

            if checkpoint_path is not None and (
                    launches % ckpt_every == 0 or steps_done >= total):
                n_files = self._save_run_checkpoint(
                    checkpoint_path, state, pending, steps_done,
                    nonce, n_files, to_host=to_host)
                pending = []
            if self.progress:
                acc = float(np.mean(host_out[1])) if n_valid else float("nan")
                print(f"[mcmc] step {steps_done}/{total} "
                      f"({'warmup' if steps_done <= self.num_warmup else 'sample'})"
                      f" accept={acc:.2f} (+{n_valid} steps/launch)",
                      flush=True)
            if (_stop_after_launches is not None
                    and launches >= _stop_after_launches
                    and steps_done < total):
                if checkpoint_path is not None and pending:
                    n_files = self._save_run_checkpoint(
                        checkpoint_path, state, pending, steps_done,
                        nonce, n_files, to_host=to_host)
                return None

        # concat per-launch outputs along the step axis, chains to front
        zs, accept, div, steps, depth, pes = (
            np.moveaxis(np.concatenate([o[i] for o in outs_host], axis=0),
                        0, 1)
            for i in range(6))

        sel = slice(self.num_warmup + self.thinning - 1, None, self.thinning)
        zs, accept, div, steps, depth, pes = (
            a[:, sel] for a in (zs, accept, div, steps, depth, pes))

        zs = jnp.asarray(zs)  # (chains, draws, zdim)
        if chain_sharding is not None:
            # draws stream to host per launch; lay the collected samples
            # back out over the mesh so downstream consumers (sharded
            # diagnostics, per-device post-processing) see the chain axis
            # distributed as during sampling
            zs = jax.device_put(zs, chain_sharding)
        self._samples_u = zs
        self._extra = dict(accept_prob=accept, diverging=div,
                           num_steps=steps, tree_depth=depth,
                           potential_energy=pes,
                           step_size=state.step_size,
                           inv_mass=state.inv_mass)
        return self

    # --- in-flight run checkpointing ---
    def _ckpt_config(self):
        # everything that changes the sampled trajectory (chunk_steps and
        # the leapfrog budget only move launch boundaries, so resuming
        # with different launch sizing is exact and allowed)
        return np.array([self.num_warmup, self.num_samples, self.num_chains,
                         self.thinning, self.max_depth,
                         min(self.warmup_depth_cap, self.max_depth),
                         min(self.warmup_depth_cap_steps, self.num_warmup),
                         int(self._dense), int(self.adapt_mass)])

    @staticmethod
    def _chunk_path(path, c):
        return f"{path}.chunk_{c:05d}.npz"

    def _clean_orphan_chunks(self, path):
        """Starting fresh: remove chunk files a previous run at the same
        path left behind, so they can never be mistaken for this run's."""
        import glob

        if jax.process_index() != 0:
            return

        for p in glob.glob(f"{path}.chunk_*.npz"):
            try:
                os.remove(p)
            except OSError:
                pass

    @staticmethod
    def _atomic_savez(path, payload):
        import tempfile

        # atomic replace so a mid-write kill cannot corrupt the checkpoint
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".npz")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)

    def _save_run_checkpoint(self, path, state, pending, steps_done,
                             nonce, n_files, to_host=np.asarray):
        """Streaming checkpoint: draws buffered since the last write go to
        ONE nonce-stamped side file (``{path}.chunk_NNNNN.npz``, always
        overwritten - never trusted from a previous run); the small
        chain-state file at ``path`` is atomically replaced afterwards.
        Returns the new side-file count.  In multi-process runs only
        process 0 touches the filesystem (every process holds the same
        replicated data, see ``to_host``)."""
        # the host gather below is a COLLECTIVE in multi-process runs:
        # every process must participate before the I/O guard
        leaves = [to_host(l) for l in jax.tree_util.tree_leaves(state)]
        if jax.process_index() != 0:
            return n_files + 1
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {"nonce": nonce}
        for i in range(6):
            payload[f"out_{i}"] = np.concatenate(
                [p[i] for p in pending], axis=0)
        self._atomic_savez(self._chunk_path(path, n_files), payload)
        n_files += 1

        main = {"config": self._ckpt_config(),
                "nonce": nonce,
                "steps_done": np.array(steps_done),
                "n_files": np.array(n_files)}
        for i, leaf in enumerate(leaves):
            main[f"state_{i}"] = leaf
        self._atomic_savez(path, main)
        return n_files

    def _load_run_checkpoint(self, path, state_template):
        if not os.path.exists(path):
            return None
        data = np.load(path, allow_pickle=False)
        if not np.array_equal(data["config"], self._ckpt_config()):
            raise ValueError(
                f"checkpoint at {path} was written with a different MCMC "
                f"configuration: {data['config']} vs {self._ckpt_config()}")
        nonce = data["nonce"][()]
        leaves, treedef = jax.tree_util.tree_flatten(state_template)
        new_leaves = [jnp.asarray(data[f"state_{i}"]).astype(l.dtype)
                      for i, l in enumerate(leaves)]
        state = jax.tree_util.tree_unflatten(treedef, new_leaves)
        outs = []
        steps = 0
        for c in range(int(data["n_files"])):
            cp = self._chunk_path(path, c)
            if not os.path.exists(cp):
                raise ValueError(
                    f"checkpoint at {path} is missing its chunk file {cp}")
            cd = np.load(cp, allow_pickle=False)
            if cd["nonce"][()] != nonce:
                raise ValueError(
                    f"chunk file {cp} belongs to a different run "
                    f"(stale nonce) - delete it or the main checkpoint")
            out = tuple(cd[f"out_{i}"] for i in range(6))
            steps += out[0].shape[0]
            outs.append(out)
        if steps != int(data["steps_done"]):
            raise ValueError(
                f"checkpoint at {path}: chunk files hold {steps} steps but "
                f"the state file says {int(data['steps_done'])}")
        return state, outs, int(data["steps_done"]), nonce, int(data["n_files"])

    # --- results ---
    def get_samples(self, group_by_chain: bool = False) -> dict:
        """Constrained-space samples per parameter name."""
        if self._samples_u is None:
            raise RuntimeError("call .run(key) first")
        u = self._samples_u
        if not group_by_chain:
            u = u.reshape(-1, u.shape[-1])
        # go through model.constrain so reparametrized models (NeuTra) map
        # their sampling space back to parameters correctly
        constrain = self.model.constrain
        for _ in range(u.ndim - 1):
            constrain = jax.vmap(constrain)
        return constrain(u)

    def get_extra_fields(self) -> dict:
        return self._extra

    @property
    def divergences(self):
        return int(np.asarray(self._extra["diverging"]).sum())

    def summary(self):
        from lqg_tpu.infer.diagnostics import summary as _summary
        return _summary(self.get_samples(group_by_chain=True))

    def print_summary(self):
        from lqg_tpu.infer.diagnostics import format_summary

        table = self.summary()
        print(format_summary(table))
        print(f"\ndivergences: {self.divergences}")
        return table
