"""Keller-Segel solver on a grid sharded over the ranks of sp.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/keller_segel_sharded.py``
(`KellerSegelShardedSolver`). The finite-difference stencils of
``ops/keller_segel.py`` need one ghost cell on each side; with the grid split
into contiguous blocks the ghosts come from the ring neighbours
(`parallel.halo.halo_exchange_1d`), and the reference's clamped boundary
(KellerSegelSetup.jl:221-224) is `periodic=False`: the first and last blocks
replicate their own edge. One exchange per right-hand side carries the ghosts
of both fields (u, v) at once. The step runs eagerly: a captured CUDA graph
(the single-device solver's form on the card) cannot hold the group's
collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from distributedconvrl_pde_control_torch.parallel.halo import halo_exchange_1d
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh


@dataclasses.dataclass(frozen=True)
class KellerSegelShardedSolver:
    """`ops.keller_segel.KellerSegelSolver`'s scheme on local grid blocks;
    `nx` is the GLOBAL grid size (dx = lx / nx as in the unsharded solver)."""

    nx: int
    lx: float
    mesh: Optional[RankMesh] = dataclasses.field(default=None, compare=False)
    chi: float = 5.6

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    def rhs(self, y: torch.Tensor, forcing: torch.Tensor) -> torch.Tensor:
        """dy/dt of local blocks y (B, 2, nx/S), forcing (B, nx/S)
        (KellerSegelSetup.jl:213-232)."""
        dx = self.dx
        u, v = y[:, 0], y[:, 1]
        g = halo_exchange_1d(y, self.mesh, halo=1, periodic=False)
        ym, yp = g[..., :-2], g[..., 2:]
        d1 = (yp - ym) / (2.0 * dx)
        d2 = (ym - 2.0 * y + yp) / (dx * dx)
        du1, dv1 = d1[:, 0], d1[:, 1]
        du2, dv2 = d2[:, 0], d2[:, 1]
        dv = dv2 - v + u + forcing
        du = du2 + u - self.chi * du1 * dv1 - self.chi * u * dv2 - u * u
        return torch.stack([du, dv], dim=1)

    @torch.no_grad()
    def step(self, y: torch.Tensor, forcing: torch.Tensor, dt: float,
             oversampling: int) -> torch.Tensor:
        """One env step = `oversampling` classic RK4 substeps on local blocks."""
        dt_os = dt / oversampling
        for _ in range(oversampling):
            k1 = self.rhs(y, forcing)
            k2 = self.rhs(y + 0.5 * dt_os * k1, forcing)
            k3 = self.rhs(y + 0.5 * dt_os * k2, forcing)
            k4 = self.rhs(y + dt_os * k3, forcing)
            y = y + dt_os / 6.0 * (k1 + 2.0 * (k2 + k3) + k4)
        return y
