"""Dense chains matching the reference network factory.

Counterpart of ``distributedconvrl_pde_control_tpu/models/mlp.py``.
Reference `create_NNA` (src/PDEagent.jl:14-56):
  actor : ns -> floor(10*nna_scale) [-> same] -> na, hidden `fun`, tanh head
  critic: ns+na -> floor(20*nna_scale) [-> same] -> 1, hidden `fun`, linear head

Convention: inputs are column-major like the reference - x has shape
(features, batch) and the actuator axis IS the batch axis (the
"convolutional" weight sharing, src/PDEagent.jl:189).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn


class Chain(nn.Module):
    """Weights w_i (n_out, n_in) and biases b_i (n_out,) of a dense chain,
    in the layout of the JAX package's [{"w", "b"}, ...] pytree."""

    def __init__(self, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(torch.as_tensor(w, dtype=torch.float32))
                                   for w in weights])
        self.b = nn.ParameterList([nn.Parameter(torch.as_tensor(b, dtype=torch.float32))
                                   for b in biases])


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
