"""Tutorial: LQG tracking models and inverse optimal control.

Runnable equivalent of the reference's ``Tutorial.ipynb``: build a model,
simulate the closed loop, look at cross-correlograms, evaluate the
marginalized likelihood over a parameter grid, run NUTS, and compute the
belief-tracking posterior.

    python examples/tutorial.py [--platform cpu]
"""

import argparse
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--platform", default=None)
args = parser.parse_args()

import jax
if args.platform:
    jax.config.update("jax_platforms", args.platform)

import jax.numpy as jnp
import numpy as np
from jax import random, vmap

from lqg_tpu.models import BoundedActor, SubjectiveActor
from lqg_tpu.ccg import xcorr
from lqg_tpu.infer import infer

# --- 1. model + closed-loop simulation ---
model = BoundedActor(T=1000, action_cost=0.5, sigma_target=6.0)
x = model.simulate(random.PRNGKey(0), n=20)
print("simulated trajectories:", x.shape)  # (20, 1001, 2)

# --- 2. cross-correlogram between target velocity and response velocity ---
vel = np.diff(np.asarray(x), axis=1)
lags, ccg = xcorr(vel[..., 1], vel[..., 0], maxlags=60)
print("CCG peak lag:", int(lags[int(np.asarray(ccg).mean(0).argmax())]))

# --- 3. likelihood over a parameter grid (vmapped constructors) ---
def loglik(action_cost):
    return jnp.sum(BoundedActor(T=1000,
                                action_cost=action_cost).log_likelihood(x))

costs = jnp.logspace(-2, 1, 25)
lls = vmap(loglik)(costs)
print("grid argmax action_cost:", float(costs[int(jnp.argmax(lls))]),
      "(true 0.5)")

# --- 4. NUTS posterior (shorter horizon so the example is quick on CPU;
# on a GPU the full T=1000 dataset is fine) ---
x_inf = BoundedActor(T=300, action_cost=0.5,
                     sigma_target=6.0).simulate(random.PRNGKey(2), n=10)
mcmc = infer(x_inf, num_samples=150, num_warmup=150,
             model=BoundedActor, num_chains=2, max_depth=8)
mcmc.print_summary()

# --- 5. subjective internal models + belief tracking ---
subj = SubjectiveActor(T=500, subj_vel_noise=1.0)
xs = subj.simulate(random.PRNGKey(1), n=5)
belief = subj.belief_tracking_distribution(xs)
print("belief posterior mean:", belief.mean.shape)  # (5, 500, bdim)
