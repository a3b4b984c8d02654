"""Build and execute ``notebooks/Tutorial.ipynb``.

Produces a notebook-grade walkthrough with real executed outputs (parity
with the reference's rendered ``notebooks/Tutorial.ipynb``,
``/root/reference/mkdocs.yml:73-77``): model definition, simulation,
cross-correlograms, the subjective-actor equivalence, the marginalized
likelihood derivation (the propagate / condition / marginalize algorithm of
reference Tutorial cell 36), gradient-based and NUTS inference, and belief
tracking.

Usage: python scripts/make_tutorial_notebook.py  (CPU; ~2-4 min)
"""

import os
import sys

import nbformat as nbf

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

md = nbf.v4.new_markdown_cell
code = nbf.v4.new_code_cell

CELLS = [
    md("""# lqg_tpu tutorial

Inverse optimal control for continuous psychophysics, on an accelerator: model a
human in a tracking experiment as an LQG agent (Kalman filter + LQR), then
infer the agent's cost and noise parameters from observed trajectories via a
marginalized closed-form Gaussian likelihood.

This notebook runs unchanged on CPU or GPU (it pins CPU here so it executes
anywhere)."""),
    code("""import os
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax
# pinned to CPU so the rendered notebook executes anywhere; delete these
# two lines to run on an accelerator
if os.environ.get("TUTORIAL_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import matplotlib.pyplot as plt
from jax import random

jax.devices()[:2], jax.default_backend()"""),
    md("""## 0. A five-minute JAX refresher

Everything in this library is built from three function transforms
(reference Tutorial cells 1-12 cover the same ground). If you know them,
skip ahead.

**`jax.grad`** differentiates any scalar-valued function written with
`jax.numpy` - including, later, a marginalized log likelihood that contains
two Riccati recursions:"""),
    code("""def f(x):
    return jnp.sin(x) ** 2

df = jax.grad(f)
float(df(1.0)), float(2 * jnp.sin(1.0) * jnp.cos(1.0))  # match"""),
    md("""**`jax.vmap`** vectorizes a function over a new batch axis without
rewriting it. Batched model evaluations (parameter grids, chains, trials)
all use it:"""),
    code("""xs = jnp.linspace(0, 2 * jnp.pi, 50)
plt.figure(figsize=(5, 2.5))
plt.plot(xs, jax.vmap(f)(xs), label="f")
plt.plot(xs, jax.vmap(df)(xs), label="f'")
plt.legend(frameon=False); plt.tight_layout()"""),
    md("""**`jax.jit`** traces a function once and compiles it with XLA. On
a GPU this is where the performance comes from: the whole
parameters → gains → likelihood graph below compiles into a single fused
device program, so Python never touches the inner loop."""),
    code("""import timeit

g = lambda x: jnp.sum(jnp.tanh(x @ x.T))
a = random.normal(random.PRNGKey(0), (200, 200))
jit_g = jax.jit(g)
jit_g(a).block_until_ready()  # compile once
t_eager = timeit.timeit(lambda: g(a).block_until_ready(), number=20)
t_jit = timeit.timeit(lambda: jit_g(a).block_until_ready(), number=20)
print(f"eager {t_eager * 50:.2f} ms/call, jit {t_jit * 50:.2f} ms/call")"""),
    md("""Two rules matter for everything below: under `jit`, shapes are
static and Python control flow runs at *trace* time (loops over time steps
become `lax.scan`), and randomness is explicit - `random.PRNGKey(seed)`
makes every simulation and every MCMC chain exactly reproducible.

## 1. A tracking task as an LQG problem

Per tracked dimension there are two states: target position (a random walk)
and cursor position (integrates the control). The agent observes both under
sensory noise and trades tracking error against effort:

$$x_{t+1} = A x_t + B u_t + V\\epsilon_t,\\qquad
y_t = F x_t + W\\eta_t,\\qquad
J = \\textstyle\\sum_t x_t^\\top Q x_t + u_t^\\top R u_t.$$

`BoundedActor` builds exactly this system (the rendered matrices below are
the `_repr_latex_` output):"""),
    code("""from lqg_tpu.models import BoundedActor

model = BoundedActor(T=1000, action_cost=0.5, action_variability=0.5,
                     sigma_target=6.0, sigma_cursor=4.0, dt=1/60)
model"""),
    md("""## 2. Simulation

`simulate` computes the LQR gain schedule (backward Riccati pass) and the
Kalman gain schedule (forward covariance pass) once, then rolls every trial
forward in a single scan with the trial axis batched into each matmul."""),
    code("""x = model.simulate(random.PRNGKey(0), n=20)
x.shape  # (trials, T+1, [target, cursor])"""),
    code("""fig, ax = plt.subplots(figsize=(7, 3))
t = jnp.arange(x.shape[1]) / 60
ax.plot(t, x[0, :, 0], label="target", lw=1)
ax.plot(t, x[0, :, 1], label="cursor", lw=1)
ax.set(xlabel="time [s]", ylabel="position [arcmin]")
ax.legend(frameon=False); fig.tight_layout()"""),
    md("""## 3. Cross-correlograms

The classic continuous-psychophysics summary statistic: correlate target
velocity with cursor velocity at all lags. Higher action costs flatten and
shift the peak; more sensory noise delays it."""),
    code("""from lqg_tpu import xcorr

fig, ax = plt.subplots(figsize=(6, 3))
for cost in [0.1, 1.0, 10.0]:
    m = BoundedActor(T=1000, action_cost=cost)
    xs = m.simulate(random.PRNGKey(1), n=20)
    lags, ccg = xcorr(jnp.diff(xs[:, :, 1]), jnp.diff(xs[:, :, 0]),
                      maxlags=120)
    ax.plot(lags / 60, ccg.mean(axis=0), label=f"action cost {cost}")
ax.set(xlabel="lag [s]", ylabel="correlation"); ax.legend(frameon=False)
fig.tight_layout()"""),
    md("""### Influence of the model parameters

Each parameter deforms tracking behavior in a characteristic way (this is
what makes the inverse problem well-posed). `vmap` over the parameter makes
the sweep one batched, jitted computation - the idiomatic replacement for
the reference tutorial's interactive sliders:"""),
    code("""sweeps = {
    "action_cost": jnp.array([0.05, 0.5, 5.0]),
    "sigma_target": jnp.array([2.0, 8.0, 32.0]),
}

fig, axes = plt.subplots(1, 2, figsize=(9, 3), sharey=True)
for ax, (name, values) in zip(axes, sweeps.items()):
    @jax.jit
    @jax.vmap
    def sim(v):
        return BoundedActor(T=600, **{name: v}).simulate(
            random.PRNGKey(4), n=1)[0]

    xs = sim(values)
    ax.plot(jnp.arange(601) / 60, xs[0, :, 0], "k", lw=1, label="target")
    for v, xi in zip(values, xs):
        ax.plot(jnp.arange(601) / 60, xi[:, 1], lw=1, label=f"{name}={v}")
    ax.set(xlabel="time [s]", title=name)
    ax.legend(frameon=False, fontsize=7)
axes[0].set(ylabel="position [arcmin]")
fig.tight_layout()"""),
    md("""High action cost makes the cursor sluggish; high sensory noise
makes it smooth but late. (Note the *same* target trace in both panels:
only the actor changed.)

## 4. Subjective actors

The agent's internal model need not match the true dynamics: a
`SubjectiveActor` believes the target has velocity (3 internal states per
dim) while the true target is a random walk. With `subj_noise=1,
subj_vel_noise=0` it must collapse to the bounded actor *exactly* - the
strongest semantic test in the suite:"""),
    code("""from lqg_tpu.models import SubjectiveActor

subj = SubjectiveActor(T=1000, subj_noise=1.0, subj_vel_noise=0.0)
x_b = BoundedActor(T=1000).simulate(random.PRNGKey(2), n=5)
x_s = subj.simulate(random.PRNGKey(2), n=5)
bool(jnp.allclose(x_b, x_s, atol=1e-4))"""),
    md("""### Exercise: your own target dynamics

Models are just `LQGSpec` pytrees; nothing is hard-coded to the random-walk
target. Here the target is mean-reverting (a discretized
Ornstein-Uhlenbeck process, the reference tutorial's damped-spring
exercise): state = (target, cursor), and only `A` changes."""),
    code("""from lqg_tpu.utils import stationary_spec
from lqg_tpu.system import System


def ou_tracking_model(theta=1.5, process_noise=1.0, action_variability=0.5,
                      sigma_target=6.0, sigma_cursor=4.0, action_cost=0.5,
                      dt=1 / 60, T=1000):
    a = jnp.exp(-theta * dt)          # OU mean reversion per step
    A = jnp.array([[a, 0.0], [0.0, 1.0]])
    B = jnp.array([[0.0], [dt]])
    F = jnp.eye(2)
    V = jnp.diag(jnp.array([process_noise, action_variability]))
    W = jnp.diag(jnp.array([sigma_target, sigma_cursor]))
    Q = jnp.array([[1.0, -1.0], [-1.0, 1.0]])
    R = jnp.eye(1) * action_cost
    spec = stationary_spec(A=A, B=B, F=F, V=V, W=W, Q=Q, R=R)
    return System(actor=spec, dynamics=spec, horizon=T)


ou = ou_tracking_model(theta=1.5)
x_ou = ou.simulate(random.PRNGKey(5), n=5)
fig, ax = plt.subplots(figsize=(7, 3))
ax.plot(jnp.arange(x_ou.shape[1]) / 60, x_ou[0, :, 0], lw=1,
        label="OU target")
ax.plot(jnp.arange(x_ou.shape[1]) / 60, x_ou[0, :, 1], lw=1, label="cursor")
ax.set(xlabel="time [s]", ylabel="position [arcmin]")
ax.legend(frameon=False); fig.tight_layout()"""),
    md("""The OU target hovers around zero instead of wandering off - and
because `simulate`, `log_likelihood`, `infer` and belief tracking all
operate on the spec, the custom model gets the full toolchain (including
the fused GPU kernels) for free.

## 5. The marginalized likelihood

The inverse problem scores observed trajectories $x_{1:T}$ under parameters
$\\theta$ *without observing the agent's beliefs*. Stack the true state and
the belief into one joint linear-Gaussian system
$z_t = (x_t, \\hat x_t)$ with closed-loop transition $F_t$ and noise
Cholesky $G_t$; then for each step:

1. **propagate** the joint Gaussian through $z_{t+1} = F_t z_t + G_t w_t$,
2. **condition** on the observed $x_t$ (a Schur-complement update on the
   leading block),
3. **marginalize** the belief block to score $x_{t+1}$.

Each conditional $p(x_{t+1} \\mid x_{1:t})$ is Gaussian in closed form, so
the log likelihood is a sum of Gaussian scores - and the whole chain
parameters → matrices → gains → likelihood is one differentiable XLA graph.
On the GPU the entire conditioned recursion (and its hand-derived adjoint) runs
as one fused Pallas kernel; long horizons can instead use an associative
scan with $O(\\log T)$ depth (`method="pscan"`)."""),
    code("""ll = model.log_likelihood(x)
ll.shape, float(ll.sum())"""),
    code("""# the likelihood surface over action cost, and its gradient
costs = jnp.logspace(-2, 1.5, 30)

@jax.jit
@jax.vmap
def ll_at(c):
    return BoundedActor(T=1000, action_cost=c).log_likelihood(x).sum()

g = jax.grad(lambda c: BoundedActor(T=1000, action_cost=c)
             .log_likelihood(x).sum())(0.5)

fig, ax = plt.subplots(figsize=(6, 3))
ax.plot(costs, ll_at(costs))
ax.axvline(0.5, color="k", ls=":", label="true value")
ax.set(xscale="log", xlabel="action cost", ylabel="log likelihood")
ax.legend(frameon=False); fig.tight_layout()
float(g)"""),
    md("""### The two-noise trade-off, on a vmapped grid

Nesting `vmap` twice evaluates the likelihood on a full 2-D parameter grid
in one compiled call. The banana-shaped ridge between the two sensory
noises is the single most important feature of this inference problem - it
is why short data leaves them weakly identified, and why the real-data
posterior in `docs/data.md` is hard to mix over:"""),
    code("""st = jnp.linspace(2.0, 14.0, 40)
sc = jnp.linspace(1.0, 10.0, 40)

@jax.jit
def ll_grid(st, sc):
    def one(s_t, s_c):
        return BoundedActor(T=1000, sigma_target=s_t,
                            sigma_cursor=s_c).log_likelihood(x).sum()
    return jax.vmap(jax.vmap(one, (None, 0)), (0, None))(st, sc)

L = ll_grid(st, sc)
fig, ax = plt.subplots(figsize=(5, 3.6))
lmax = L.max()
cs = ax.contourf(sc, st, L, levels=jnp.linspace(lmax - 300, lmax, 25),
                 extend="min")
ax.plot(4.0, 6.0, "w*", ms=12, label="truth")
ax.set(xlabel="sigma_cursor", ylabel="sigma_target")
ax.legend(frameon=False); fig.colorbar(cs, label="log likelihood")
fig.tight_layout()"""),
    md("""### Maximum likelihood

For a point estimate, `lqg_tpu.optim.minimize` bridges the jitted value-
and-gradient to `scipy.optimize.minimize` (L-BFGS) on pytree parameters:"""),
    code("""from lqg_tpu.infer.mle import max_likelihood

mle, losses = max_likelihood(x, model=BoundedActor, steps=800)
{k: round(float(v), 3) for k, v in mle.items()}"""),
    md("""## 6. Bayesian inference (native NUTS)

`infer` runs the framework's own NUTS (chains vmapped on-device, warmup
adaptation compiled into one re-launched chunk program). Priors follow the
reference's defaults; initialization is at the prior medians."""),
    code("""from lqg_tpu.infer import infer

mcmc = infer(x[:, :301], num_samples=200, num_warmup=200,
             model=BoundedActor, num_chains=2, seed=0)
mcmc.print_summary()"""),
    md("""True values: action_cost 0.5, action_variability 0.5, sigma_target
6.0, sigma_cursor 4.0. On this deliberately short horizon (300 steps) the
motor noise is pinned while the two sensory noises stay weakly identified
(wide, correlated marginals) - exactly the behavior the eLife paper
documents for short data. `scripts/recover.py` runs the full-length
(T=720, 5000-draw) recovery study.

## 7. Belief tracking

Given fitted parameters, the experimenter's posterior over what the
*subject* believed at each moment is another closed-form Gaussian:"""),
    code("""belief = model.belief_tracking_distribution(x)
fig, ax = plt.subplots(figsize=(7, 3))
ax.plot(t[1:], x[0, 1:, 0], label="target", lw=1)
ax.plot(t[1:], belief.loc[0, :, 0], label="posterior mean of belief", lw=1)
ax.set(xlabel="time [s]", ylabel="position [arcmin]")
ax.legend(frameon=False); fig.tight_layout()"""),
    md("""## 8. Real data

The Bonnen et al. (2015) dataset ships with the reference; the loader
reproduces its preprocessing exactly (parity-tested against the
reference)."""),
    code("""from lqg_tpu.io import load_tracking_data

data, blob_widths = load_tracking_data(delay=12, clip=180,
                                       subtract_mean=False)
m = BoundedActor(T=data.shape[2] - 1, sigma_target=float(blob_widths[0]))
data.shape, float(m.log_likelihood(jnp.asarray(data[0])).sum())"""),
    md("""`scripts/fit_data.py` runs the full hierarchical fit
(`shared_params_lqg_model`: shared parameters across the six blob-width
conditions, per-condition sigma_target) and writes an arviz-compatible
netCDF posterior."""),
]


def main():
    nb = nbf.v4.new_notebook()
    nb.cells = CELLS
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": "python3"}

    outdir = os.path.join(ROOT, "notebooks")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "Tutorial.ipynb")

    from nbconvert.preprocessors import ExecutePreprocessor

    ep = ExecutePreprocessor(timeout=1200, kernel_name="python3")
    ep.preprocess(nb, {"metadata": {"path": ROOT}})
    with open(path, "w") as f:
        nbf.write(nb, f)
    print("wrote executed notebook:", path)


if __name__ == "__main__":
    main()
