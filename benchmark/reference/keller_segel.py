"""Plain reference of the KellerSegel10_16 configuration: the Keller-Segel
chemotaxis control env of arXiv 2301.10737 (`KellerSegelSetup.jl:24-405` of
the paper's code) and the sharded trainer's step on it at one device, in
float32 PyTorch with TF32 off.

Two fields on nx points of [0, lx], u (cells) and v (chemo-attractant):

    u_t = u_xx + u - chi u_x v_x - chi u v_xx - u^2
    v_t = v_xx - v + u + f

with central differences whose ghost values are the boundary values (the
clamped ends of `KellerSegelSetup.jl:221-224`), stepped by classical RK4 at
`oversampling` substeps per env step, every operation launched one by one.
Sensors are top hats of 2 half_window + 1 points at grid points 3, 8, ...;
the observation of actuator i is the 3-sensor window around its sensor of
both fields' dots scaled by sensor_scale, stacked over the last 2 steps; the
forcing is agent_power times the actions on the actuators' top hats, into
the v equation; the reward of actuator i is -(<u - 1, rect_i>^2 / 800); an
episode ends after te/dt steps or when |u| or |v| passes max_value.

Departures from the Julia reference, as the port's trainer has them: many
envs stepped in lockstep and their columns pushed into one replay; a learner
batch of 32 and one update per env step (the Julia setup: 3 and 20); resets
in the step from a pool of fresh fields drawn once (the Julia loop draws one
at each episode's start); a non-finite reward clamped to -max_value before
the push. The fresh fields are generate_random_init's sines
(`KellerSegelSetup.jl:373-384`) with coefficients from numpy's generator of
the seed, as the port's pool draws them.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nets
from benchmark.reference.ks import cols


def no_tf32() -> None:
    """Float32 products and convolutions in full precision on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rectangles(cfg: dict) -> np.ndarray:
    """(n_sensors, nx) top hats of 2 half_window + 1 ones centred on the
    1-based grid points 3, 8, ..., nx - 2."""
    nx, h = cfg["nx"], cfg["half_window"]
    centres = np.arange(3, nx + 1, 5)
    out = np.zeros((len(centres), nx))
    for i, c in enumerate(centres):
        out[i, c - 1 - h:c + h] = 1.0
    return out


def actuator_sensors() -> np.ndarray:
    """The sensors (0-based) of the 16 actuators: 3:18 in Julia's 1-based
    indices."""
    return np.arange(2, 18)


def random_fields(cfg: dict, seed: int, count: int, device) -> torch.Tensor:
    """`count` fields u, v = 1 + sum over i of a_i sin(i x / (2 pi lx / 22)),
    i = 1..ceil(lx / 3), x the grid points dx..lx, with u's and v's
    coefficients drawn together uniform in [-1, 1) from numpy's generator of
    `seed` and scaled to unit length; float32 (count, 2, nx)."""
    nx, lx = cfg["nx"], cfg["lx"]
    n_sin = int(np.ceil(lx / 3.0))
    x = np.arange(1, nx + 1) * (lx / nx)
    modes = np.stack([np.sin(i * x / (2.0 * np.pi * lx / 22.0)) for i in range(1, n_sin + 1)])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = rng.uniform(-1.0, 1.0, 2 * n_sin)
        a = a / np.sqrt(np.sum(a * a))
        out.append(np.stack([1.0 + a[:n_sin] @ modes, 1.0 + a[n_sin:] @ modes]))
    return torch.as_tensor(np.stack(out), dtype=torch.float32, device=device)


class KellerSegelReference:
    """The Keller-Segel env of one configuration on one device."""

    def __init__(self, cfg: dict, device, precision: str = "float32"):
        self.cfg = cfg
        self.mm = nets.matmul(precision)
        rect = rectangles(cfg)
        a2s = actuator_sensors()
        self.rect = torch.as_tensor(rect, dtype=torch.float32, device=device)
        self.act_rect = self.rect[torch.as_tensor(a2s, device=device)]
        self.a2s = torch.as_tensor(a2s, device=device)
        self.dx = cfg["lx"] / cfg["nx"]

    # ---------------------------------------------------------------- PDE
    def rhs(self, y: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """dy/dt of y (B, 2, nx), rows (u, v), forcing f (B, nx)."""
        g = torch.cat([y[..., :1], y, y[..., -1:]], dim=-1)  # ghost values: the end values
        left, right = g[..., :-2], g[..., 2:]
        dx = self.dx
        first = (right - left) / (2.0 * dx)
        second = (left - 2.0 * y + right) / (dx * dx)
        u, v = y[:, 0], y[:, 1]
        chi = 5.6
        du = second[:, 0] + u - chi * first[:, 0] * first[:, 1] - chi * u * second[:, 1] - u * u
        dv = second[:, 1] - v + u + f
        return torch.stack([du, dv], dim=1)

    def pde_step(self, y: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        n = self.cfg["oversampling"]
        h = self.cfg["dt"] / n
        for _ in range(n):
            k1 = self.rhs(y, f)
            k2 = self.rhs(y + 0.5 * h * k1, f)
            k3 = self.rhs(y + 0.5 * h * k2, f)
            k4 = self.rhs(y + h * k3, f)
            y = y + h / 6.0 * (k1 + 2.0 * (k2 + k3) + k4)
        return y

    # ---------------------------------------------------------------- env
    def dots(self, y: torch.Tensor) -> torch.Tensor:
        """(B, 2, n_sensors) dots of both fields with every sensor."""
        b, nf, nx = y.shape
        return self.mm(y.reshape(b * nf, nx), self.rect.T).reshape(b, nf, -1)

    def observe(self, dots: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
        """(B, 12, n_act): per field the sensor window (rolls -1, 0, 1 along
        the sensors) at the actuators' sensors, then the previous
        observation's newest block (the same block twice at a reset)."""
        w = self.cfg["window_size"] // 2
        rows = [torch.roll(dots[:, f] * self.cfg["sensor_scale"], i, dims=-1)[:, self.a2s]
                for f in range(2) for i in range(-w, w + 1)]
        block = torch.stack(rows, dim=1)
        older = block if prev is None else prev[:, :block.shape[1]]
        return torch.cat([block, older], dim=1)

    def step(self, y, prev_action, steps, action, max_steps: int):
        """(y', its dots, reward, done) of one env step; `action` (B, 1,
        n_act)."""
        cfg = self.cfg
        a0 = action[:, 0]
        forcing = cfg["agent_power"] * self.mm(a0, self.act_rect)
        y_new = self.pde_step(y, forcing)
        d = self.dots(y_new)
        off = self.mm(y_new[:, 0] - 1.0, self.act_rect.T)  # <u - 1, rect_i>
        reward = (-(off ** 2 / cfg["reward_norm"]).abs() - cfg["action_punish"] * a0 ** 2
                  - cfg["delta_action_punish"] * (a0 - prev_action[:, 0]) ** 2)
        blowup = ((y_new.abs().flatten(1).amax(-1) > cfg["max_value"])
                  | ~torch.isfinite(reward).all(-1))
        return y_new, d, reward, (steps + 1 >= max_steps) | blowup


def train_steps(cfg: dict, inputs: dict, n_steps: int, precision: str = "float32",
                fault: str | None = None) -> dict:
    """The trainer's first `n_steps` steps from `inputs` (seed of the reset
    pool, actor, critic, draws: per step noise, replay offsets, reset rows);
    returns per step the mean reward; per update the losses and the sizes
    of the Q values in them, the batch's mean |Q(s, a)| under the critic
    before the update and mean |Q(s, actor(s))| under the updated critic;
    the first update's gradients, the leaves before and after, and the first
    and last fields."""
    dev = inputs["device"]
    if torch.device(dev).type == "cuda":
        no_tf32()
    env = KellerSegelReference(cfg, dev, precision)
    mm = env.mm
    n_act, b = len(actuator_sensors()), cfg["n_envs"]
    pool = random_fields(cfg, inputs["seed"], cfg["y0_pool_size"], dev)
    pool_obs = env.observe(env.dots(pool), None)
    rows = torch.arange(b, device=dev) % pool.shape[0]
    y, obs = pool[rows], pool_obs[rows]
    prev = torch.zeros((b, 1, n_act), device=dev)
    steps = torch.zeros(b, dtype=torch.int32, device=dev)
    agent = nets.make_agent(inputs["actor"], inputs["critic"], cfg["agent"])
    replay = nets.Replay(cfg["agent"]["capacity"], b * n_act, agent.ns, 1, dev)
    out = {"mean_reward": [], "losses": [], "q_scale": [], "grads": None, "init_field": y.clone(),
           "before": [t.clone() for t in nets.leaves(agent.actor) + nets.leaves(agent.critic)]}
    for d in inputs["draws"][:n_steps]:
        agent.update_step += 1
        obs_flat = cols(obs)
        a_flat = nets.act(agent, obs_flat, mm, d.get("noise"), d.get("start"))
        actions = a_flat.reshape(1, b, n_act).movedim(1, 0)
        y_new, dots, reward, done = env.step(y, prev, steps, actions, cfg["max_steps"])
        obs_new = env.observe(dots, obs)
        safe_r = torch.where(torch.isfinite(reward), reward, -cfg["max_value"])
        replay.push(obs_flat, a_flat, safe_r.reshape(-1),
                    done.to(torch.float32).repeat_interleave(n_act), cols(obs_new))
        if replay.size > cfg["agent"]["update_after"] * n_act:
            batch = replay.sample(d["offs"])
            if fault == "half_batch":
                batch = tuple(x[..., :x.shape[-1] // 2] for x in batch)
            s, a = batch[0], batch[1]
            q_sa, _ = nets.forward(agent.critic, torch.cat([s, a], 0), "linear", mm)
            actor_before = nets.clone_chain(agent.actor)
            res = nets.learn(agent, batch, mm)
            a_pol, _ = nets.forward(actor_before, s, "tanh", mm)
            q_pol, _ = nets.forward(agent.critic, torch.cat([s, a_pol], 0), "linear", mm)
            out["losses"].append((res["critic_loss"], res["actor_loss"]))
            out["q_scale"].append((float(q_sa.abs().mean()), float(q_pol.abs().mean())))
            if out["grads"] is None:
                out["grads"] = res["grads"]
        dc = done.reshape(b, 1, 1)
        y = torch.where(dc, pool[d["idx"]], y_new)
        obs = torch.where(dc, pool_obs[d["idx"]], obs_new)
        prev = torch.where(dc, 0.0, actions)
        steps = torch.where(done, 0, steps + 1)
        out["mean_reward"].append(float(safe_r.mean(-1).mean()))
    out["after"] = nets.leaves(agent.actor) + nets.leaves(agent.critic)
    out["field"] = y
    return out
