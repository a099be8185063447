"""Dense chains matching the reference network factory.

Counterpart of ``distributedconvrl_pde_control_tpu/models/mlp.py``.
Reference `create_NNA` (src/PDEagent.jl:14-56):
  actor : ns -> floor(10*nna_scale) [-> same] -> na, hidden `fun`, tanh head
  critic: ns+na -> floor(20*nna_scale) [-> same] -> 1, hidden `fun`, linear head
with glorot-uniform weights and zero biases (Flux Dense defaults).

Convention: inputs are column-major like the reference - x has shape
(features, batch) and the actuator axis IS the batch axis (the
"convolutional" weight sharing, src/PDEagent.jl:189).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn


def _owned(x) -> torch.Tensor:
    """A float32 tensor with storage of its own: an optimizer updates a
    chain's parameters in place, which must never reach the array they were
    made from (a numpy view of a JAX buffer, another chain's weights)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32))


class Chain(nn.Module):
    """Weights w_i (n_out, n_in) and biases b_i (n_out,) of a dense chain,
    in the layout of the JAX package's [{"w", "b"}, ...] pytree. The chain
    owns copies of the arrays it is given."""

    def __init__(self, weights: Sequence, biases: Sequence):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(_owned(w)) for w in weights])
        self.b = nn.ParameterList([nn.Parameter(_owned(b)) for b in biases])


def glorot_uniform(generator: torch.Generator, n_out: int, n_in: int) -> torch.Tensor:
    """(n_out, n_in) weights uniform in +-sqrt(6 / (n_in + n_out)), drawn on
    the generator's device."""
    limit = math.sqrt(6.0 / (n_in + n_out))
    u = torch.rand((n_out, n_in), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (2.0 * u - 1.0) * limit


def init_chain(generator: torch.Generator, sizes: Sequence[int], device="cuda") -> Chain:
    """A dense chain with the given layer sizes on `device`: glorot-uniform
    weights from `generator` (drawn on its device, then moved), zero biases."""
    weights = [glorot_uniform(generator, n_out, n_in) for n_in, n_out in zip(sizes[:-1], sizes[1:])]
    return Chain(weights, [torch.zeros(n_out) for n_out in sizes[1:]]).to(device)


def copy_chain(params: Chain) -> Chain:
    """A detached copy of a chain on the same device: what a snapshot of
    parameters that an optimizer updates in place has to be."""
    return Chain(list(params.w), list(params.b))


def chain_to_numpy(params: Chain) -> list:
    """A chain as the JAX package's [{"w", "b"}, ...] pytree of numpy arrays
    (the format of `best_actor_w{i}`/`best_actor_b{i}` in saves/hook.npz)."""
    return [{"w": w.detach().cpu().numpy().copy(), "b": b.detach().cpu().numpy().copy()}
            for w, b in zip(params.w, params.b)]


def apply_chain(params: Chain, x: torch.Tensor, hidden_act: Callable = torch.relu,
                final_act: Callable | None = None) -> torch.Tensor:
    """y = chain(x) for x of shape (features,) or (features, batch)."""
    squeeze = x.dim() == 1
    h = x[:, None] if squeeze else x
    n = len(params.w)
    for i, (w, b) in enumerate(zip(params.w, params.b)):
        h = w @ h + b[:, None]
        if i < n - 1:
            h = hidden_act(h)
        elif final_act is not None:
            h = final_act(h)
    return h[:, 0] if squeeze else h


def actor_sizes(ns: int, na: int, nna_scale: float, drop_middle_layer: bool):
    """Layer sizes per create_NNA (PDEagent.jl:15,19-29)."""
    h = int(math.floor(10 * nna_scale))
    return [ns, h, na] if drop_middle_layer else [ns, h, h, na]


def critic_sizes(ns: int, na: int, nna_scale: float, drop_middle_layer: bool):
    """Layer sizes per create_NNA (PDEagent.jl:16,31-43)."""
    h = int(math.floor(20 * nna_scale))
    return [ns + na, h, 1] if drop_middle_layer else [ns + na, h, h, 1]
