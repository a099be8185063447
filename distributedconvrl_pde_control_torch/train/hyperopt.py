"""Hyperparameter search driver over a preset's setup.

Counterpart of ``distributedconvrl_pde_control_tpu/train/hyperopt.py``; the
draws come from numpy's `Generator`, so a seed gives the trials the JAX
package gives. The CLI searches around the mono KS22_global setup, KS22,
KS200 and both Keller-Segel presets (`experiments/run.py::HYPEROPT_PRESETS`,
the JAX CLI's bases).

The reference exposes `test_setup` as a hyperopt objective
(KSglobalSetup.jl:405-426) whose candidate hyperparameters are the
positional arguments of `initialize_setup` (KSglobalSetup.jl:269):
nna_scale, nna_scale_critic, drop_middle_layer(+_critic), gamma, polyak,
batch_size, update_freq, trajectory_length, learning_rate, act_noise — but
ships no loop that actually calls it. This module is that loop: seeded
random search over the same axes, each trial building a fresh setup and
scoring it with `drivers.hyperopt_objective` (the test_setup cost).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np


# search axes = initialize_setup's positional hyperparameters
# (KSglobalSetup.jl:269); ranges bracket the shipped values
SEARCH_SPACE = {
    "nna_scale": ("loguniform", 1.0, 12.0),
    "nna_scale_critic": ("loguniform", 10.0, 120.0),
    "drop_middle_layer": ("choice", (True, False)),
    "gamma": ("choice", (0.95, 0.99, 0.995)),
    "polyak": ("choice", (0.99, 0.995, 0.999)),
    "batch_size": ("choice", (3, 8, 16, 32)),
    "update_freq": ("choice", (1, 2, 4)),
    "capacity": ("choice", (150_000, 700_000)),  # trajectory_length
    "learning_rate": ("loguniform", 1e-4, 3e-3),
    "act_noise": ("uniform", 0.3, 2.0),
}


def sample_trial(rng: np.random.Generator, space=None) -> dict:
    space = space or SEARCH_SPACE
    out = {}
    for name, spec in space.items():
        kind = spec[0]
        if kind == "loguniform":
            out[name] = float(np.exp(rng.uniform(np.log(spec[1]), np.log(spec[2]))))
        elif kind == "uniform":
            out[name] = float(rng.uniform(spec[1], spec[2]))
        elif kind == "choice":
            out[name] = spec[1][int(rng.integers(len(spec[1]))) ]
        else:
            raise ValueError(kind)
    return out


def search(base_cfg, build_fn: Callable, n_trials: int = 8, seed: int = 0,
           n_episodes: int = 30, space: Optional[dict] = None,
           verbose: bool = True, objective: Optional[Callable] = None):
    """Random search: `n_trials` sampled configs, each scored by
    `objective(setup, n_episodes=...)` (lower = better; defaults to the
    reference's `hyperopt_objective`, see also `hyperopt_objective_robust`).
    Returns (best dict, all trials).

    `build_fn(cfg) -> Setup` (e.g. configs.ks.build_ks_global); `base_cfg` a
    dataclass config whose fields the sampled trial overrides.
    """
    from distributedconvrl_pde_control_torch.train.drivers import hyperopt_objective

    score = objective if objective is not None else hyperopt_objective
    rng = np.random.default_rng(seed)
    trials = []
    best = {"cost": np.inf, "params": None, "trial": -1}
    for i in range(n_trials):
        params = sample_trial(rng, space)
        cfg = dataclasses.replace(base_cfg, **params)
        t0 = time.time()
        try:
            cost = score(build_fn(cfg), n_episodes=n_episodes)
        # a diverging config is a bad trial, not a crash; a failure of the
        # kernels or the device (RuntimeError, OSError) is not caught
        except (ArithmeticError, ValueError) as e:
            cost = float("inf")
            params = {**params, "error": repr(e)[:200]}
        row = {"trial": i, "cost": None if np.isinf(cost) else round(cost, 5),
               "seconds": round(time.time() - t0, 1), **params}
        trials.append(row)
        if cost < best["cost"]:
            best = {"cost": cost, "params": params, "trial": i}
        if verbose:
            print(json.dumps(row), flush=True)
    if verbose:
        print(json.dumps({"best_trial": best["trial"],
                          "best_cost": round(float(best["cost"]), 5),
                          "best_params": best["params"]}), flush=True)
    return best, trials
