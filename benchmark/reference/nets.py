"""Plain DDPG of the reference: dense chains with their gradients written
out, Adam written out, Polyak averaging and a ring replay of
[s | a | r | t | sn] rows.

The learn step is the one of the paper's agent (arXiv 2301.10737; the
reference's `PDEagent.jl:363-418`):

    a'      = target_actor(s')
    q_t     = r + gamma * (1 - t) * target_critic([s'; a'])
    critic <- Adam(grad mean((q_t - critic([s; a]))^2))
    actor  <- Adam(grad -mean(critic_updated([s; actor(s)])))
    targets <- polyak * targets + (1 - polyak) * behaviour

Every matrix product goes through `mm`, so that the control can run the same
arithmetic with its operands rounded to TF32 (`matmul("tf32")`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (nearest, ties away
    from zero), the operands a TF32 tensor core multiplies."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(precision: str) -> Mm:
    """The reference's matrix product: float32 as the configuration states
    it, or the control's TF32 (operands rounded, float32 accumulation)."""
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        return lambda a, b: torch.matmul(round_tf32(a), round_tf32(b))
    raise ValueError(f"unknown precision {precision!r}")


def ieee_matmuls() -> None:
    """Float32 products in full precision on the card (TF32 off)."""
    try:
        torch.backends.cuda.matmul.fp32_precision = "ieee"
    except AttributeError:  # a torch without the precision API: TF32 is off by default
        pass


# ----------------------------------------------------------------- chains
def chain_sizes(n_in: int, n_out: int, width: float, scale: float) -> list[int]:
    """n_in -> floor(width * scale) -> n_out, the preset's chains (the
    middle layer dropped)."""
    return [n_in, int(math.floor(width * scale)), n_out]


def glorot_chain(gen: torch.Generator, sizes: list[int], device) -> list[list[torch.Tensor]]:
    """[[w, b], ...]: glorot-uniform weights, zero biases, drawn on the
    generator's device in one call per layer."""
    out = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        limit = math.sqrt(6.0 / (n_in + n_out))
        u = torch.rand((n_out, n_in), generator=gen, dtype=torch.float32, device=gen.device)
        out.append([((2.0 * u - 1.0) * limit).to(device), torch.zeros(n_out, device=device)])
    return out


def clone_chain(chain):
    return [[w.clone(), b.clone()] for w, b in chain]


def leaves(chain) -> list[torch.Tensor]:
    return [t for layer in chain for t in layer]


def forward(chain, x: torch.Tensor, final: str, mm: Mm):
    """Output of the chain on columns x (features, cols), relu hidden
    layers, `final` "tanh" or "linear"; and what the backward pass needs."""
    acts, pres = [x], []
    h = x
    for i, (w, b) in enumerate(chain):
        z = mm(w, h) + b[:, None]
        pres.append(z)
        if i < len(chain) - 1:
            h = torch.relu(z)
        else:
            h = torch.tanh(z) if final == "tanh" else z
        acts.append(h)
    return h, (acts, pres, final)


def backward(chain, cache, d_out: torch.Tensor, mm: Mm, params: bool = True):
    """Gradients of the chain's leaves and of its input, given the gradient
    of its output."""
    acts, pres, final = cache
    grads = [None] * len(chain)
    d = d_out
    for i in reversed(range(len(chain))):
        if i == len(chain) - 1:
            if final == "tanh":
                d = d * (1.0 - acts[i + 1] ** 2)
        else:
            d = d * (pres[i] > 0)
        w, _ = chain[i]
        if params:
            grads[i] = [mm(d, acts[i].T), d.sum(dim=1)]
        d = mm(w.T, d)
    return grads, d


# ------------------------------------------------------------------- Adam
class Adam:
    """torch.optim.Adam's update (b1 0.9, b2 0.999, eps 1e-8 outside the
    root, both moments bias-corrected), written out."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m = self.v = None

    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> None:
        if self.m is None:
            self.m = [torch.zeros_like(p) for p in params]
            self.v = [torch.zeros_like(p) for p in params]
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.lerp_(g, 1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / bc1)


# ------------------------------------------------------------------ agent
@dataclasses.dataclass
class Agent:
    actor: list
    critic: list
    target_actor: list
    target_critic: list
    opt_actor: Adam
    opt_critic: Adam
    gamma: float
    polyak: float
    ns: int
    act_noise: float
    start_steps: int
    update_step: int = 0


def make_agent(actor, critic, cfg: dict) -> Agent:
    """An agent around copies of the given chains; targets equal to them."""
    return Agent(actor=clone_chain(actor), critic=clone_chain(critic),
                 target_actor=clone_chain(actor), target_critic=clone_chain(critic),
                 opt_actor=Adam(cfg["learning_rate"]), opt_critic=Adam(cfg["learning_rate_critic"]),
                 gamma=cfg["gamma"], polyak=cfg["polyak"], ns=cfg["ns"],
                 act_noise=cfg["act_noise"], start_steps=cfg["start_steps"])


def act(agent: Agent, obs_cols: torch.Tensor, mm: Mm, noise=None, start=None):
    """The learning policy's actions (na, cols): the start policy's actions
    while update_step <= start_steps, else actor + act_noise * noise,
    clamped to [-1, 1]. The caller bumps update_step first."""
    a, _ = forward(agent.actor, obs_cols, "tanh", mm)
    if agent.update_step <= agent.start_steps:
        a = start
    else:
        a = a + noise * agent.act_noise
    return torch.clamp(a, -1.0, 1.0)


def learn(agent: Agent, batch, mm: Mm) -> dict:
    """One DDPG update in place; returns the losses and the gradients as
    the two optimizers get them (actor's and critic's leaves)."""
    s, a, r, t, sn = batch
    bsz = r.shape[0]
    a_next, _ = forward(agent.target_actor, sn, "tanh", mm)
    q_next, _ = forward(agent.target_critic, torch.cat([sn, a_next], 0), "linear", mm)
    q_target = r + agent.gamma * (1.0 - t) * q_next.reshape(-1)

    q, cache = forward(agent.critic, torch.cat([s, a], 0), "linear", mm)
    diff = q_target - q.reshape(-1)
    c_loss = torch.mean(diff ** 2)
    g_critic, _ = backward(agent.critic, cache, (-2.0 / bsz * diff)[None], mm)
    agent.opt_critic.step(leaves(agent.critic), leaves(g_critic))

    a_pol, cache_a = forward(agent.actor, s, "tanh", mm)
    q2, cache_c = forward(agent.critic, torch.cat([s, a_pol], 0), "linear", mm)
    a_loss = -torch.mean(q2)
    _, dx = backward(agent.critic, cache_c, torch.full_like(q2, -1.0 / bsz), mm, params=False)
    g_actor, _ = backward(agent.actor, cache_a, dx[agent.ns:], mm)
    agent.opt_actor.step(leaves(agent.actor), leaves(g_actor))

    behaviour = leaves(agent.actor) + leaves(agent.critic)
    for tgt, p in zip(leaves(agent.target_actor) + leaves(agent.target_critic), behaviour):
        tgt.mul_(agent.polyak).add_(p, alpha=1.0 - agent.polyak)
    return {"critic_loss": float(c_loss), "actor_loss": float(a_loss),
            "grads": leaves(g_actor) + leaves(g_critic)}


# ----------------------------------------------------------------- replay
class Replay:
    """Ring buffer of [s | a | r | t | sn] rows; capacity rounded up to a
    multiple of the push width, so that a push never wraps."""

    def __init__(self, capacity: int, push: int, ns: int, na: int, device):
        capacity = (capacity + push - 1) // push * push
        self.buf = torch.zeros((capacity, 2 * ns + na + 2), dtype=torch.float32, device=device)
        self.ns, self.na = ns, na
        self.ptr = self.size = 0

    def push(self, s, a, r, t, sn) -> None:
        n = r.shape[0]
        self.buf[self.ptr:self.ptr + n] = torch.cat([s.T, a.T, r[:, None], t[:, None], sn.T], 1)
        self.ptr = (self.ptr + n) % self.buf.shape[0]
        self.size = min(self.size + n, self.buf.shape[0])

    def sample(self, offs: torch.Tensor):
        cap = self.buf.shape[0]
        start = self.ptr if self.size >= cap else 0
        rows = self.buf[(offs + start) % cap]
        ns, na = self.ns, self.na
        return (rows[:, :ns].T, rows[:, ns:ns + na].T, rows[:, ns + na], rows[:, ns + na + 1],
                rows[:, ns + na + 2:].T)
