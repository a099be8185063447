"""Plain reference of the Fluid_16_256 configuration: the 2D Navier-Stokes
vorticity control env of arXiv 2301.10737 (`FluidSetup.jl` of the paper's
code) on the 2/3-rule solver, and the sharded fluid trainer's step on one
device, in float32 PyTorch.

w_t = -u . grad w + nu lap w + f on the periodic unit square, n x n points,
stepped by classical RK4 at floor(16 n dt) substeps per env step on spectra
(`torch.fft`): u = (dpsi/dy, -dpsi/dx) with psi = w / k^2, the product formed
in real space from the real parts of full complex inverses, and the
advection masked by the 2/3 rule. Sensors and actuators are thresholded
Taylor vortices on a spa x spa lattice; the observation of actuator i is the
3 x 3 window of scaled sensor dots around it; the reward is -|<w, g_i>|^1.1
/ 320 - 0.002 a_i^2 - 0.002 (a_i - a_i,prev)^2; an episode ends after te/dt
steps or when a reward's magnitude passes max_value.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nets
from benchmark.reference.ks import cols


def taylor_vortices(n: int, lx: float, x0, y0, a0, umax, device) -> torch.Tensor:
    """Sum over k of Taylor vortices (x0_k, y0_k, a0_k, umax_k) with their
    3 x 3 periodic images on the n x n grid, float64 (K, n, n) when the
    parameters are (K,) vectors."""
    x = torch.linspace(0.0, lx, n + 1, dtype=torch.float64, device=device)[:n]
    xx, yy = x[None, None, :], x[None, :, None]
    p = [torch.as_tensor(np.asarray(v, np.float64), device=device).reshape(-1, 1, 1)
         for v in (x0, y0, a0, umax)]
    out = torch.zeros((p[0].shape[0], n, n), dtype=torch.float64, device=device)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            r2 = (xx - p[0] - i * lx) ** 2 + (yy - p[1] - j * lx) ** 2
            out += p[3] / p[2] * (2.0 - r2 / p[2] ** 2) * torch.exp(0.5 * (1.0 - r2 / p[2] ** 2))
    return out


def random_fields(cfg: dict, seed: int, count: int, device) -> torch.Tensor:
    """`count` fields of 30 random Taylor vortices of radius lx/20 (the
    paper's training initial condition), drawn from numpy's generator of
    `seed` in the order x0, y0, umax per vortex; float32 (count, n, n)."""
    n, lx = cfg["grid_nx"], cfg["lx"]
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(count):
        params = np.array([[rng.uniform(0, lx), rng.uniform(0, lx), rng.uniform(-1.0, 1.0)]
                           for _ in range(30)])
        w = taylor_vortices(n, lx, params[:, 0], params[:, 1], np.full(30, lx / 20.0),
                            params[:, 2], device).sum(0)
        fields.append(w)
    return torch.stack(fields).to(torch.float32)


class FluidReference:
    def __init__(self, cfg: dict, device, precision: str = "float32"):
        self.cfg = cfg
        self.device = device
        self.mm = nets.matmul(precision)
        n, lx = cfg["grid_nx"], cfg["lx"]
        k = np.concatenate([np.arange(0, n // 2 + 1), np.arange(-n // 2 + 1, 0)]) * 2.0 * np.pi / lx
        kv = torch.as_tensor(k.astype(np.float32), device=device)
        self.kx = kv[None, :].expand(n, n)
        self.ky = kv[:, None].expand(n, n)
        k2 = self.ky * self.ky + self.kx * self.kx
        self.inv_k2 = torch.where(k2 == 0, 0.0, 1.0 / torch.where(k2 == 0, 1.0, k2))
        self.lin = -cfg["nu"] * k2
        keep = torch.as_tensor(np.abs(np.fft.fftfreq(n) * n) <= n // 3, device=device)
        self.mask = (keep[:, None] & keep[None, :]).to(torch.float32)
        spa = cfg["sensors_per_axis"]
        step = n // spa
        pos = [(i, j) for i in range(1, n + 1, step) for j in range(1, n + 1, step)]
        dx = lx / n
        vort = taylor_vortices(n, lx, [(i - 1) * dx for i, _ in pos], [(j - 1) * dx for _, j in pos],
                               np.full(len(pos), cfg["variance"]), np.ones(len(pos)), device)
        vort = torch.where(vort < 0.1, 0.0, vort)
        self.sensors = (vort / vort.sum((1, 2), keepdim=True)).to(torch.float32).reshape(len(pos), -1)
        self.actuators = (vort / vort.amax((1, 2), keepdim=True)).to(torch.float32)
        self.substeps = int(np.floor(16 * n * cfg["dt"]))

    # ---------------------------------------------------------------- PDE
    def _rhs(self, w, f):
        kx, ky = self.kx, self.ky
        psi = w * self.inv_k2
        u = torch.fft.ifft2(1j * ky * psi).real
        v = torch.fft.ifft2(-1j * kx * psi).real
        wx = torch.fft.ifft2(1j * kx * w).real
        wy = torch.fft.ifft2(1j * ky * w).real
        return self.lin * w + torch.fft.fft2(-u * wx - v * wy) * self.mask + f

    def pde_step(self, w: torch.Tensor, forcing: torch.Tensor) -> torch.Tensor:
        h = self.cfg["dt"] / self.substeps
        wh = torch.fft.fft2(w)
        fh = torch.fft.fft2(forcing)
        for _ in range(self.substeps):
            k1 = self._rhs(wh, fh)
            k2 = self._rhs(wh + 0.5 * h * k1, fh)
            k3 = self._rhs(wh + 0.5 * h * k2, fh)
            k4 = self._rhs(wh + h * k3, fh)
            wh = wh + h / 6.0 * (k1 + 2.0 * (k2 + k3) + k4)
        return torch.fft.ifft2(wh).real

    # ---------------------------------------------------------------- env
    def dots(self, w):
        return self.mm(w.flatten(1), self.sensors.T)

    def observe(self, dots):
        spa = self.cfg["sensors_per_axis"]
        s = (dots * self.cfg["sensor_scale"]).reshape(-1, spa, spa)
        h = self.cfg["window_size"] // 2
        return torch.stack([torch.roll(s, (i, j), dims=(-2, -1)).flatten(-2)
                            for i in range(-h, h + 1) for j in range(-h, h + 1)], dim=1)

    def step(self, w, prev_action, steps, action):
        """(w', obs', reward, done, completed) of one env step."""
        cfg = self.cfg
        a0 = action[:, 0]
        forcing = cfg["agent_power"] * self.mm(a0, self.actuators.flatten(1)).reshape(w.shape)
        w_new = self.pde_step(w, forcing)
        d = self.dots(w_new)
        reward = (-(d.abs() ** cfg["reward_pow"] / cfg["reward_norm"]).abs()
                  - cfg["action_punish"] * a0 ** 2
                  - cfg["delta_action_punish"] * (a0 - prev_action[:, 0]) ** 2)
        blowup = (reward.abs().amax(-1) > cfg["max_value"]) | ~torch.isfinite(reward).all(-1)
        horizon = steps + 1 >= cfg["max_steps"]
        return w_new, self.observe(d), reward, horizon | blowup, horizon & ~blowup


def train_steps(cfg: dict, inputs: dict, n_steps: int, precision: str = "float32",
                fault: str | None = None) -> dict:
    """The fluid trainer's first `n_steps` steps from `inputs` (seed of the
    reset pool, actor, critic, draws: per step start/noise actions, replay
    offsets, reset rows); returns what `ks.train_steps` returns."""
    dev = inputs["device"]
    fl = FluidReference(cfg, dev, precision)
    mm = fl.mm
    n_act, b = cfg["sensors_per_axis"] ** 2, cfg["n_envs"]
    pool = random_fields(cfg, inputs["seed"], cfg["y0_pool_size"], dev)
    pool_obs = fl.observe(fl.dots(pool))
    rows = torch.arange(b, device=dev) % pool.shape[0]
    w, obs = pool[rows], pool_obs[rows]
    prev = torch.zeros((b, 1, n_act), device=dev)
    steps = torch.zeros(b, dtype=torch.int32, device=dev)
    agent = nets.make_agent(inputs["actor"], inputs["critic"], cfg["agent"])
    replay = nets.Replay(cfg["agent"]["capacity"], b * n_act, agent.ns, 1, dev)
    out = {"mean_reward": [], "losses": [], "grads": None, "init_field": w.clone(),
           "before": [t.clone() for t in nets.leaves(agent.actor) + nets.leaves(agent.critic)]}
    for d in inputs["draws"][:n_steps]:
        agent.update_step += 1
        obs_flat = cols(obs)
        a_flat = nets.act(agent, obs_flat, mm, d.get("noise"), d.get("start"))
        actions = a_flat.reshape(1, b, n_act).movedim(1, 0)
        w_new, obs_new, reward, done, _ = fl.step(w, prev, steps, actions)
        safe_r = torch.where(torch.isfinite(reward), reward, -cfg["max_value"])
        replay.push(obs_flat, a_flat, safe_r.reshape(-1),
                    done.to(torch.float32).repeat_interleave(n_act), cols(obs_new))
        if replay.size > cfg["agent"]["update_after"] * n_act:
            batch = replay.sample(d["offs"])
            if fault == "half_batch":
                batch = tuple(x[..., :x.shape[-1] // 2] for x in batch)
            res = nets.learn(agent, batch, mm)
            out["losses"].append((res["critic_loss"], res["actor_loss"]))
            if out["grads"] is None:
                out["grads"] = res["grads"]
        dc = done.reshape(b, 1, 1)
        w = torch.where(dc, pool[d["idx"]], w_new)
        obs = torch.where(dc, pool_obs[d["idx"]], obs_new)
        prev = torch.where(dc, 0.0, actions)
        steps = torch.where(done, 0, steps + 1)
        out["mean_reward"].append(float(safe_r.mean(-1).mean()))
    out["after"] = nets.leaves(agent.actor) + nets.leaves(agent.critic)
    out["field"] = w
    return out
