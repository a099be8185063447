"""Plain reference of the KS22 configuration: the Kuramoto-Sivashinsky
control env of arXiv 2301.10737 (`KSSetup.jl:20-245` of the paper's code)
and the batched DDPG trainer's step on it, in float32 PyTorch.

u_t = -u u_x - u_xx - u_xxxx + f on a periodic domain of length lx with nx
points, stepped by CNAB2 (Crank-Nicolson on the linear part, Adams-Bashforth
2 on the nonlinear one) at `oversampling` substeps per env step, through
`torch.fft`. Sensors and actuators are periodic Gaussians; the observation
of actuator i is its sensor's dot product scaled by 1/max_value; the reward
of actuator i is -|<6 y, g_i>|^1.3 / (3 max_value) - 0.002 a_i^2 - 0.002
(a_i - a_i,prev)^2. The operators are made here in float64 from the
configuration's numbers and cast to float32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nets


def gaussian_kernels(cfg: dict, sigma: float, norm_mode: int) -> np.ndarray:
    """(n_kernels, nx) periodic Gaussians at grid points 1, 1 + step, ...:
    exp(-(x - x_i)^2 / 2 * sigma^2) on a grid extended by 50 points each
    side, normalised by the sum (sensors) or the maximum (actuators), the
    tails wrapped around."""
    nx, lx = cfg["nx"], cfg["lx"]
    dx = lx / nx
    extra = 50
    t = np.arange(1 - extra, nx + extra + 1) * dx
    positions = np.arange(1, nx + 1, cfg["sensor_step"])
    out = np.zeros((len(positions), nx))
    for i, pos in enumerate(positions):
        p = np.exp(-((t - pos * dx) ** 2) / 2.0 * sigma ** 2) / np.sqrt(2.0 * np.pi * sigma)
        p = p / (p.sum() if norm_mode == 1 else p.max())
        core = p[extra:extra + nx].copy()
        core[nx - extra:] += p[:extra]
        right = p[extra + nx:]
        core[:len(right)] += right
        out[i] = core
    return out


class KSReference:
    """The KS env of one configuration on one device."""

    def __init__(self, cfg: dict, device, precision: str = "float32"):
        self.cfg = cfg
        self.device = device
        self.mm = nets.matmul(precision)
        nx, lx = cfg["nx"], cfg["lx"]
        dt_os = cfg["dt"] / cfg["oversampling"]
        k = np.arange(nx // 2 + 1, dtype=np.float64)
        k[-1] = 0.0  # the Nyquist mode is zeroed, as the paper's solver does
        alpha = 2.0 * np.pi * k / lx
        lin = alpha ** 2 - alpha ** 4
        x = np.arange(1, nx + 1) * (lx / nx)
        dist = np.fft.rfft(cfg["mu"] * np.cos(2.0 + np.pi + x / (lx / 2.0))) * dt_os

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

        self.half_alpha = f32(0.5 * alpha)
        self.a_inv = f32(1.0 / (1.0 - dt_os / 2.0 * lin))
        self.b_op = f32(1.0 + dt_os / 2.0 * lin)
        self.dist = torch.complex(f32(dist.real), f32(dist.imag))
        self.dt_os = dt_os
        sensors = gaussian_kernels(cfg, cfg["sigma_sensors"], 1)
        actuators = gaussian_kernels(cfg, cfg["sigma_actuators"], 2)[:cfg["n_actuators"]]
        self.sensors = f32(sensors)
        self.actuators = f32(actuators)
        self.reward_rows = self.sensors[:cfg["n_actuators"]]

    # ---------------------------------------------------------------- PDE
    def _nonlinear(self, u_hat):
        """-0.5 i alpha * F(u^2) given F(u^2)."""
        return torch.complex(self.half_alpha * u_hat.imag, -self.half_alpha * u_hat.real)

    def pde_step(self, y: torch.Tensor, forcing: torch.Tensor) -> torch.Tensor:
        """One env step (`oversampling` CNAB2 substeps) of fields (B, nx)
        under a forcing held constant over it."""
        nx = self.cfg["nx"]
        dt = self.dt_os
        u_hat = torch.fft.rfft(y)
        n_prev = self._nonlinear(torch.fft.rfft(y * y))
        f_hat = torch.fft.rfft(forcing) * dt
        for _ in range(self.cfg["oversampling"]):
            u = torch.fft.irfft(u_hat, n=nx)
            n_new = self._nonlinear(torch.fft.rfft(u * u))
            u_hat = self.a_inv * (self.b_op * u_hat + 1.5 * dt * n_new - 0.5 * dt * n_prev
                                  + f_hat) + self.dist
            n_prev = n_new
        return torch.fft.irfft(u_hat, n=nx)

    # ---------------------------------------------------------------- env
    def observe(self, y: torch.Tensor) -> torch.Tensor:
        """(B, nx) -> (B, window, n_act): scaled sensor dots, a window of
        neighbouring sensors, the actuators' columns."""
        cfg = self.cfg
        s = self.mm(y, self.sensors.T) / cfg["max_value"]
        h = cfg["window_size"] // 2
        rows = torch.stack([torch.roll(s, i, dims=-1) for i in range(-h, h + 1)], dim=1)
        return rows[:, :, :cfg["n_actuators"]]

    def reset(self, y0: torch.Tensor) -> dict:
        b = y0.shape[0]
        zeros = torch.zeros((b, 1, self.cfg["n_actuators"]), device=self.device)
        return {"y": y0, "obs": self.observe(y0), "action": zeros,
                "steps": torch.zeros(b, dtype=torch.int32, device=self.device)}

    def step(self, st: dict, action: torch.Tensor):
        """The env step on a batch: (new state, reward (B, n_act), done,
        completed)."""
        cfg = self.cfg
        a0 = action[:, 0]
        delta = a0 - st["action"][:, 0]
        forcing = cfg["agent_power"] * self.mm(a0, self.actuators)
        y = self.pde_step(st["y"], forcing)
        dots = self.mm(y * 6.0, self.reward_rows.T).abs() ** 1.3 / (cfg["max_value"] * 3.0)
        reward = (-dots.abs() - cfg["action_punish"] * a0 ** 2
                  - cfg["delta_action_punish"] * delta ** 2)
        steps = st["steps"] + 1
        time = (torch.tensor(cfg["t0"], dtype=torch.float32)
                + steps.to(torch.float32) * torch.tensor(cfg["dt"], dtype=torch.float32))
        horizon = time >= cfg["te"] * (1.0 - 1e-6)
        finite = torch.isfinite(y).all(-1) & torch.isfinite(reward).all(-1)
        done = horizon | (y.abs().amax(-1) > cfg["max_value"]) | ~finite
        new = {"y": y, "obs": self.observe(y), "action": action, "steps": steps}
        return new, reward, done, done & horizon


def pick(mask, new: dict, old: dict) -> dict:
    """Per env, `new` where mask (B,) is true and `old` elsewhere."""
    return {k: torch.where(mask.reshape((-1,) + (1,) * (v.dim() - 1)), v, old[k])
            for k, v in new.items()}


def cols(obs: torch.Tensor) -> torch.Tensor:
    """(B, ns, n_act) -> (ns, B*n_act), env-major columns."""
    return obs.permute(1, 0, 2).reshape(obs.shape[1], -1)


def train_steps(cfg: dict, inputs: dict, n_steps: int, precision: str = "float32",
                fault: str | None = None) -> dict:
    """The batched trainer's first `n_steps` steps from `inputs` (pool,
    init_idx, actor, critic, draws: per step start/noise actions, replay
    offsets, reset rows). Returns the mean reward of each step, the losses
    of each update, the gradients of the first update, the leaves before
    and after, and the fields after the last step. `fault` "half_batch"
    plants a learner that takes the mean over half of each sampled batch."""
    dev = inputs["pool"].device
    ks = KSReference(cfg, dev, precision)
    mm = ks.mm
    n_act, b = cfg["n_actuators"], cfg["n_envs"]
    agent = nets.make_agent(inputs["actor"], inputs["critic"], cfg["agent"])
    pool_state = ks.reset(inputs["pool"])
    st = {k: v[inputs["init_idx"]] for k, v in pool_state.items()}
    replay = nets.Replay(cfg["agent"]["capacity"], b * n_act, agent.ns, 1, dev)
    out = {"mean_reward": [], "losses": [], "grads": None,
           "before": [t.clone() for t in nets.leaves(agent.actor) + nets.leaves(agent.critic)]}
    for d in inputs["draws"][:n_steps]:
        agent.update_step += 1
        obs_flat = cols(st["obs"])
        a_flat = nets.act(agent, obs_flat, mm, d.get("noise"), d.get("start"))
        actions = a_flat.reshape(1, b, n_act).permute(1, 0, 2)
        new, reward, done, _ = ks.step(st, actions)
        fresh = {k: v[d["idx"]] for k, v in pool_state.items()}
        st = pick(done, fresh, new)
        safe_r = torch.where(torch.isfinite(reward), reward, -cfg["max_value"])
        replay.push(obs_flat, a_flat, safe_r.reshape(-1),
                    done.to(torch.float32).repeat_interleave(n_act), cols(st["obs"]))
        if replay.size > cfg["agent"]["update_after"] * n_act:
            batch = replay.sample(d["offs"])
            if fault == "half_batch":
                batch = tuple(x[..., :x.shape[-1] // 2] for x in batch)
            res = nets.learn(agent, batch, mm)
            out["losses"].append((res["critic_loss"], res["actor_loss"]))
            if out["grads"] is None:
                out["grads"] = res["grads"]
        out["mean_reward"].append(float(safe_r.mean()))
    out["after"] = nets.leaves(agent.actor) + nets.leaves(agent.critic)
    out["field"] = st["y"]
    return out


def control_steps(cfg: dict, actor, states: list, precision: str = "float32") -> list:
    """Each recorded control step again from the program's state before it
    (y, previous action, observation): the deterministic actor's action,
    the next field and the reward."""
    dev = states[0]["y"].device
    ks = KSReference(cfg, dev, precision)
    out = []
    for s in states:
        a, _ = nets.forward(actor, cols(s["obs"]), "tanh", ks.mm)
        action = torch.clamp(a, -1.0, 1.0).reshape(1, 1, -1).permute(1, 0, 2)
        st = {"y": s["y"], "obs": s["obs"], "action": s["prev_action"],
              "steps": torch.zeros(1, dtype=torch.int32, device=dev)}
        new, reward, _, _ = ks.step(st, action)
        out.append({"action": action, "reward": reward, "y": new["y"]})
    return out


def control_start(cfg: dict, actor, y0: torch.Tensor, n_steps: int,
                  precision: str = "float32") -> dict:
    """The first `n_steps` control steps from the reset of y0 (1, nx): the
    actions, the rewards and the field after each."""
    ks = KSReference(cfg, y0.device, precision)
    st = ks.reset(y0)
    acts, rews, ys = [], [], []
    for _ in range(n_steps):
        a, _ = nets.forward(actor, cols(st["obs"]), "tanh", ks.mm)
        action = torch.clamp(a, -1.0, 1.0).reshape(1, 1, -1).permute(1, 0, 2)
        st, reward, _, _ = ks.step(st, action)
        acts.append(action)
        rews.append(reward)
        ys.append(st["y"])
    return {"action": acts, "reward": rews, "y": ys}


def random_fields(cfg: dict, gen: torch.Generator, n: int) -> torch.Tensor:
    """`n` initial fields (n, nx) of the paper's KS training: 8 sines
    sin(i x / 2 pi) with coefficients uniform in [-1, 1] normalised to unit
    norm, the field rescaled to norm 30; drawn on the generator's device."""
    nx, lx = cfg["nx"], cfg["lx"]
    x = torch.arange(1, nx + 1, dtype=torch.float32, device=gen.device) * (lx / nx)
    harmonics = torch.stack([torch.sin(i * x / (2.0 * np.pi)) for i in range(1, 9)])
    a = torch.rand((n, 8), generator=gen, device=gen.device) * 2.0 - 1.0
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    y = a @ harmonics
    return y * 30.0 / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
