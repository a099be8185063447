"""PPO agent variant.

Counterpart of ``distributedconvrl_pde_control_tpu/agents/ppo.py``, the
rebuild of `create_agent_ppo` (src/PDEagent.jl:462-512): Gaussian-policy actor
(64-64 relu trunk, tanh mu head and a logsigma head), 64-64-1 critic, clip
ratio 0.2, 10 epochs x 32 microbatches per update, value coefficient 0.5,
entropy coefficient 0.0, gradient norm clipped at 0.5, Adam. Rollouts of a
batch of envs feed GAE(lambda) advantages, then the epoch and microbatch
optimization.

The "convolutional" weight sharing carries over: every actuator column of
every env is one PPO sample, obs (B_env, ns, n_act) flattening to
(ns, B_env * n_act) (PDEagent.jl:505-510).

Where the JAX package returns new pytrees, `PPOState` holds `Chain`s that
`PPOAgent.update` changes in place, and the optimizer is written out: one
global-norm clip over the whole {trunk, mu, logsig, critic} tree (optax's
`clip_by_global_norm`: the gradient is scaled by max_norm / norm only where
the norm reaches max_norm, with nothing added to the norm) before one Adam
over that tree (optax's `adam`). Its step count and the update count are host
integers; nothing is read back from the device inside an iteration.
`train_ppo` reads one mean reward per iteration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from distributedconvrl_pde_control_torch.envs.pde_env import index_state, where_state
from distributedconvrl_pde_control_torch.models.mlp import (
    Chain,
    apply_chain,
    chain_to_numpy,
    init_chain,
)
from distributedconvrl_pde_control_torch.train.batched import eval_rollout, score_rollout

PARAM_NAMES = ("trunk", "mu", "logsig", "critic")
LOG_2PI = math.log(2.0 * math.pi)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    ns: int
    na: int
    hidden: int = 64  # PDEagent.jl:477-487
    gamma: float = 0.99
    # the reference passes its polyak constant 0.995 as GAE lambda
    # (PDEagent.jl:491); the JAX package defaults to the conventional 0.95
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    n_epochs: int = 10
    n_microbatches: int = 32
    actor_loss_weight: float = 1.0
    critic_loss_weight: float = 0.5
    entropy_loss_weight: float = 0.0
    max_grad_norm: float = 0.5
    learning_rate: float = 1e-3
    rollout_len: int = 64  # the reference's update_freq / trajectory capacity
    act_limit: float = 1.0


def tuned_config(ns: int, na: int) -> PPOConfig:
    """The CLI's tuned light protocol (JAX run.py:697-701): rollout 50, 16
    microbatches, 4 epochs, lr 3e-4."""
    return PPOConfig(ns=ns, na=na, rollout_len=50, n_microbatches=16, n_epochs=4,
                     learning_rate=3e-4)


@dataclasses.dataclass
class PPOState:
    trunk: Chain
    mu: Chain
    logsig: Chain
    critic: Chain
    # optax ScaleByAdamState: the step count and the first and second moments,
    # one tensor per tensor of `param_tensors(params)`
    adam_count: int
    adam_mu: list
    adam_nu: list
    update_count: int


def param_tensors(params: dict) -> list:
    """The parameter tensors of a {trunk, mu, logsig, critic} dict of chains,
    in one fixed order (per chain, per layer: w then b)."""
    return [t for name in PARAM_NAMES for w, b in zip(params[name].w, params[name].b)
            for t in (w, b)]


def params_to_numpy(params: dict) -> dict:
    """A params dict as the JAX package's pytree of numpy arrays (copies)."""
    return {name: chain_to_numpy(params[name]) for name in PARAM_NAMES}


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """Chains on `device` from a JAX-format {name: [{"w", "b"}, ...]} tree."""
    return {name: Chain([np.asarray(l["w"], np.float32) for l in tree[name]],
                        [np.asarray(l["b"], np.float32) for l in tree[name]]).to(device)
            for name in PARAM_NAMES}


@dataclasses.dataclass
class PPODraws:
    """Draws of one `collect_and_update` made outside it (tests pass the JAX
    package's own): `y0s` the first reset's fields (n_envs, ...); `eps` the
    standard normal action draws (T, na, n_envs*n_act); `fresh` the
    auto-reset fields (T, n_envs, ...); `perms` the epochs' permutations
    (n_epochs, T*n_envs*n_act). A field left None is drawn from the
    generator."""

    y0s: Optional[torch.Tensor] = None
    eps: Optional[torch.Tensor] = None
    fresh: Optional[torch.Tensor] = None
    perms: Optional[torch.Tensor] = None


class PPOAgent:
    def __init__(self, cfg: PPOConfig):
        self.cfg = cfg

    # --------------------------------------------------------------- params
    def init_state(self, generator: torch.Generator, device="cuda") -> PPOState:
        """Glorot-uniform chains from `generator` (trunk, mu, logsig, critic
        in that order), zero Adam moments, counts 0."""
        cfg = self.cfg
        params = {
            "trunk": init_chain(generator, [cfg.ns, cfg.hidden, cfg.hidden], device),
            "mu": init_chain(generator, [cfg.hidden, cfg.na], device),
            "logsig": init_chain(generator, [cfg.hidden, cfg.na], device),
            "critic": init_chain(generator, [cfg.ns, cfg.hidden, cfg.hidden, 1], device),
        }
        return self.make_state(params)

    def make_state(self, params: dict, adam_count: int = 0, adam_mu=None, adam_nu=None,
                   update_count: int = 0) -> PPOState:
        """A state around the given chains; zero Adam moments unless given."""
        tensors = param_tensors(params)
        zeros = lambda: [torch.zeros_like(t, requires_grad=False) for t in tensors]  # noqa: E731
        return PPOState(**params, adam_count=int(adam_count),
                        adam_mu=zeros() if adam_mu is None else adam_mu,
                        adam_nu=zeros() if adam_nu is None else adam_nu,
                        update_count=int(update_count))

    @staticmethod
    def _params(s: PPOState) -> dict:
        return {name: getattr(s, name) for name in PARAM_NAMES}

    # -------------------------------------------------------------- network
    def dist(self, params: dict, obs: torch.Tensor):
        """obs (ns, B) -> (mu, sigma), each (na, B). Trunk relu-relu, tanh mu
        head (PDEagent.jl:476-482), logsigma clipped to [-10, 2]."""
        h = apply_chain(params["trunk"], obs, torch.relu, torch.relu)
        mu = apply_chain(params["mu"], h, torch.relu, torch.tanh)
        logsig = torch.clamp(apply_chain(params["logsig"], h, torch.relu, None), -10.0, 2.0)
        return mu, torch.exp(logsig)

    def value(self, params: dict, obs: torch.Tensor) -> torch.Tensor:
        return apply_chain(params["critic"], obs, torch.relu, None)[0]

    def sample(self, params: dict, obs: torch.Tensor, eps: torch.Tensor):
        """(raw_action, env_action, logp) for standard normal draws `eps`
        (na, B): the raw sample goes into the batch (its logp must match what
        `update` recomputes), the clipped copy is what the env executes."""
        mu, sig = self.dist(params, obs)
        action = mu + sig * eps
        logp = self._logp(mu, sig, action)
        return action, torch.clamp(action, -self.cfg.act_limit, self.cfg.act_limit), logp

    @staticmethod
    def _logp(mu, sig, action):
        """Diagonal Gaussian log prob, summed over the action dim -> (B,)."""
        z = (action - mu) / sig
        return torch.sum(-0.5 * z ** 2 - torch.log(sig) - 0.5 * LOG_2PI, dim=0)

    # ------------------------------------------------------------------ GAE
    def gae(self, rewards, values, dones, last_value):
        """rewards/values/dones (T, B), last_value (B,) -> (advantages,
        returns), each (T, B): the reverse GAE(lambda) recursion."""
        cfg = self.cfg
        advs = []
        adv, v_next = torch.zeros_like(last_value), last_value
        for t in range(rewards.shape[0] - 1, -1, -1):
            mask = 1.0 - dones[t]
            delta = rewards[t] + cfg.gamma * v_next * mask - values[t]
            adv = delta + cfg.gamma * cfg.gae_lambda * mask * adv
            v_next = values[t]
            advs.append(adv)
        advs = torch.stack(advs[::-1])
        return advs, advs + values

    # --------------------------------------------------------------- update
    def _loss(self, params: dict, obs, act, old_logp, adv, ret):
        cfg = self.cfg
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)  # numpy's ddof=0
        mu, sig = self.dist(params, obs)
        ratio = torch.exp(self._logp(mu, sig, act) - old_logp)
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - cfg.clip_range, 1 + cfg.clip_range) * adv)
        actor_loss = -torch.mean(surr)
        critic_loss = torch.mean((ret - self.value(params, obs)) ** 2)
        entropy = torch.mean(torch.sum(torch.log(sig) + 0.5 * (LOG_2PI + 1.0), dim=0))
        total = (cfg.actor_loss_weight * actor_loss + cfg.critic_loss_weight * critic_loss
                 - cfg.entropy_loss_weight * entropy)
        return total, actor_loss, critic_loss

    @torch.no_grad()
    def _apply_gradients(self, state: PPOState, params: list, grads: list) -> None:
        """optax.chain(clip_by_global_norm(max_grad_norm), adam(lr)), in place."""
        cfg = self.cfg
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm),
                            cfg.max_grad_norm / norm)
        torch._foreach_mul_(grads, scale)
        state.adam_count += 1
        torch._foreach_mul_(state.adam_mu, ADAM_B1)
        torch._foreach_add_(state.adam_mu, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(state.adam_nu, ADAM_B2)
        torch._foreach_addcmul_(state.adam_nu, grads, grads, value=1.0 - ADAM_B2)
        bc1 = 1.0 - ADAM_B1 ** state.adam_count
        bc2 = 1.0 - ADAM_B2 ** state.adam_count
        denom = torch._foreach_div(state.adam_nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        step = torch._foreach_div(state.adam_mu, bc1)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-cfg.learning_rate)

    def update(self, state: PPOState, batch: dict, generator: Optional[torch.Generator] = None,
               perms: Optional[torch.Tensor] = None):
        """batch: flat tensors over N = T*B samples: obs (ns, N), actions
        (na, N), logp, adv, ret (N,). `n_epochs` epochs, each a fresh
        permutation (drawn from `generator`, or row e of `perms`) cut into
        `n_microbatches` microbatches of N // n_microbatches (the tail is
        dropped). In place on `state`; returns (state, losses (n_epochs,
        n_microbatches, 2) of actor and critic on the device)."""
        cfg = self.cfg
        n = batch["logp"].shape[0]
        mb = n // cfg.n_microbatches
        params = self._params(state)
        tensors = param_tensors(params)
        device = batch["logp"].device
        losses = []
        for e in range(cfg.n_epochs):
            if perms is None:  # a uniform permutation, the argsort of uniform draws
                perm = torch.argsort(torch.rand(n, generator=generator,
                                                device=generator.device)).to(device)
            else:
                perm = perms[e].to(device)
            for i in range(cfg.n_microbatches):
                idx = perm[i * mb:(i + 1) * mb]
                total, a_loss, c_loss = self._loss(
                    params, batch["obs"].index_select(1, idx),
                    batch["actions"].index_select(1, idx), batch["logp"][idx], batch["adv"][idx],
                    batch["ret"][idx])
                grads = list(torch.autograd.grad(total, tensors))
                self._apply_gradients(state, tensors, grads)
                losses.append(torch.stack([a_loss.detach(), c_loss.detach()]))
        state.update_count += 1
        return state, torch.stack(losses).reshape(cfg.n_epochs, cfg.n_microbatches, 2)


class PPOTrainer:
    """Rollout collection and update on a batch of envs.

    The actuator columns are the PPO env axis: obs (B_env, ns, n_act) flattens
    to (ns, B_env * n_act) and every actuator transition is a sample. Initial
    fields come from `random_init(generator, n)`, or a (P, ...) `y0_pool`
    sampled uniformly at every reset, else the env's y0; `eval_y0_pool` holds
    out the ICs of the deterministic selection eval, as `BatchedTrainer`'s
    does."""

    def __init__(self, env, agent: PPOAgent, n_envs: int, random_init: Optional[Callable] = None,
                 y0_pool=None, eval_y0_pool=None):
        self.env = env
        self.agent = agent
        self.n_envs = n_envs
        self.random_init = random_init
        self.y0_pool = y0_pool
        self.eval_y0_pool = eval_y0_pool
        self._state_pool = None

    def _y0s(self, generator: torch.Generator) -> torch.Tensor:
        if self.y0_pool is not None:
            idx = torch.randint(0, self.y0_pool.shape[0], (self.n_envs,), generator=generator,
                                device=generator.device)
            return self.y0_pool[idx.to(self.y0_pool.device)]
        if self.random_init is not None:
            return self.random_init(generator, self.n_envs)
        return self.env.y0.expand((self.n_envs,) + tuple(self.env.y0.shape))

    def _eval_y0s(self, generator: torch.Generator) -> torch.Tensor:
        """Eval ICs: the held-out `eval_y0_pool` when given, else the
        training IC source."""
        if self.eval_y0_pool is not None:
            idx = torch.randint(0, self.eval_y0_pool.shape[0], (self.n_envs,),
                                generator=generator, device=generator.device)
            return self.eval_y0_pool[idx.to(self.eval_y0_pool.device)]
        return self._y0s(generator)

    def _fresh_states(self, generator, y0s=None):
        """Reset states for the auto-reset: the env reset from `y0s`, or
        without them, with a y0 pool, the pool's reset states (computed once)
        gathered at drawn rows, else the env reset from drawn fields."""
        if self.y0_pool is not None and y0s is None:
            if self._state_pool is None:
                self._state_pool = self.env.reset(self.y0_pool)
            idx = torch.randint(0, self.y0_pool.shape[0], (self.n_envs,), generator=generator,
                                device=generator.device)
            return index_state(self._state_pool, idx.to(self.y0_pool.device))
        return self.env.reset(self._y0s(generator) if y0s is None else y0s)

    # ------------------------------------------------------------------ eval
    def eval_mean_reward(self, params: dict, n_steps: int,
                         generator: Optional[torch.Generator] = None,
                         warmup_steps: int = 0, y0s: Optional[torch.Tensor] = None) -> float:
        """Deterministic mean-policy evaluation over one episode batch: the
        mean per-step reward over active steps, with `BatchedTrainer`'s
        long-horizon semantics (past the episode cap the rollout runs on a
        te-extended clone of the env; blow-ups mask later steps, and a
        non-finite step is left out) and its zero-action warmup. `y0s`
        (n_envs, ...) replaces the drawn ICs."""
        if y0s is None:
            y0s = self._eval_y0s(generator or torch.Generator().manual_seed(0))
        limit = self.agent.cfg.act_limit

        def act_cols(obs):
            return torch.clamp(self.agent.dist(params, obs)[0], -limit, limit)

        rs, actives = eval_rollout(self.env, act_cols, y0s, n_steps, warmup_steps)
        return score_rollout(rs, actives, "mean")

    # ----------------------------------------------------------------- train
    def make_train_iter(self):
        """`collect_and_update(pstate, generator, draws=None) -> (pstate,
        mean reward)`: every env reset at the start, `rollout_len` steps of
        the sampled policy (finished envs reset inside the rollout), GAE
        bootstrapped from the last value, then `agent.update`. In place on
        `pstate`; the mean reward stays on the device."""
        env, agent = self.env, self.agent
        cfg = agent.cfg
        n_act = env.action_shape[1]
        n_envs = self.n_envs
        b = n_envs * n_act

        def cols(obs):
            return obs.permute(1, 0, 2).reshape(cfg.ns, b)

        def collect_and_update(pstate: PPOState, generator: torch.Generator,
                               draws: Optional[PPODraws] = None):
            draws = draws or PPODraws()
            params = agent._params(pstate)
            with torch.no_grad():
                estates = env.reset(self._y0s(generator) if draws.y0s is None else draws.y0s)
                traj = {k: [] for k in ("obs", "actions", "logp", "rewards", "values", "dones")}
                for t in range(cfg.rollout_len):
                    obs = cols(estates.obs)
                    eps = (torch.randn((cfg.na, b), generator=generator, dtype=torch.float32,
                                       device=generator.device).to(obs.device)
                           if draws.eps is None else draws.eps[t].to(obs.device))
                    action_raw, action_env, logp = agent.sample(params, obs, eps)
                    value = agent.value(params, obs)
                    new = env.step(estates, action_env.reshape(cfg.na, n_envs, n_act)
                                   .permute(1, 0, 2))
                    fresh = self._fresh_states(
                        generator, None if draws.fresh is None else draws.fresh[t])
                    estates = where_state(new.done, fresh, new)
                    for k, v in (("obs", obs), ("actions", action_raw), ("logp", logp),
                                 ("rewards", new.reward.reshape(b)), ("values", value),
                                 ("dones", new.done.to(torch.float32).repeat_interleave(n_act))):
                        traj[k].append(v)
                last_value = agent.value(params, cols(estates.obs))
                rewards = torch.stack(traj["rewards"])
                adv, ret = agent.gae(rewards, torch.stack(traj["values"]),
                                     torch.stack(traj["dones"]), last_value)
                # (T, dim, B) sample axes flattened t-major: (dim, T*B)
                batch = {"obs": torch.stack(traj["obs"], dim=1).reshape(cfg.ns, -1),
                         "actions": torch.stack(traj["actions"], dim=1).reshape(cfg.na, -1),
                         "logp": torch.stack(traj["logp"]).reshape(-1),
                         "adv": adv.reshape(-1), "ret": ret.reshape(-1)}
            agent.update(pstate, batch, generator, draws.perms)
            return pstate, rewards.mean()

        return collect_and_update


def ppo_policy(agent: PPOAgent, params: dict):
    """The evaluation policy of PPO params: the clipped mean action. Maps
    observations (B, ns, n_act) to actions (B, na, n_act), every actuator
    column of every env one sample."""
    limit = agent.cfg.act_limit

    @torch.no_grad()
    def policy_fn(obs):
        b, ns, n_act = obs.shape
        mu, _ = agent.dist(params, obs.permute(1, 0, 2).reshape(ns, b * n_act))
        return torch.clamp(mu, -limit, limit).reshape(-1, b, n_act).permute(1, 0, 2)

    return policy_fn


def train_ppo(trainer: PPOTrainer, iters: int, generator: Optional[torch.Generator] = None,
              verbose: bool = True, eval_every: int = 0, eval_steps: int = 50,
              eval_warmup_steps: int = 0, pstate: Optional[PPOState] = None):
    """PPO training driver: `iters` collect-and-update iterations with
    best-params snapshots. `eval_every > 0` runs the deterministic mean-policy
    eval every N iterations (and at the last) and selects the best params on
    it; otherwise the selection is on the iteration's mean rollout reward.
    `generator` (default: the env's device's, seeded 0) makes every draw,
    the initial networks first unless `pstate` is given.

    Returns (PPOState, dict with rewards / best_params (numpy pytree) /
    best_reward / best_iter / evals / selection)."""
    agent = trainer.agent
    if generator is None:
        generator = torch.Generator(device=trainer.env.y0.device).manual_seed(0)
    if pstate is None:
        pstate = agent.init_state(generator, trainer.env.y0.device)
    it = trainer.make_train_iter()
    rewards, evals = [], []
    best = {"reward": -np.inf, "iter": 0, "params": None}
    for i in range(iters):
        pstate, mean_r = it(pstate, generator)
        r = float(mean_r)  # the iteration's one read
        rewards.append(r)
        if eval_every:
            if (i + 1) % eval_every == 0 or i + 1 == iters:
                r_eval = trainer.eval_mean_reward(agent._params(pstate), eval_steps,
                                                  warmup_steps=eval_warmup_steps)
                evals.append((i + 1, r_eval))
                if r_eval > best["reward"]:
                    best.update(reward=r_eval, iter=i + 1,
                                params=params_to_numpy(agent._params(pstate)))
        elif r > best["reward"]:
            best.update(reward=r, iter=i + 1, params=params_to_numpy(agent._params(pstate)))
        if verbose and (i + 1) % max(1, iters // 10) == 0:
            tail = f" eval {evals[-1][1]:.4f}" if evals else ""
            print(f"[ppo] iter {i + 1}/{iters} mean step reward {r:.4f} "
                  f"(best {best['reward']:.4f} @ {best['iter']}){tail}")
    return pstate, {"rewards": np.asarray(rewards), "best_params": best["params"],
                    "best_reward": best["reward"], "best_iter": best["iter"], "evals": evals,
                    "selection": "eval" if eval_every else "rollout"}
