"""Ghost cells for stencils on a 1D grid sharded over the ranks of sp.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/halo.py``
(`halo_exchange_1d`), where two `ppermute`s over a ring hand each block its
neighbours' edge cells. Here both edges of every block cross the sp group in
one `all_gather` (`RankMesh.all_gather`): the edges are `halo` cells wide,
and one collective in place of two halves the number of round trips. Used
by the sharded Keller-Segel solver (`parallel/keller_segel_sharded.py`).
"""

from __future__ import annotations

from typing import Optional

import torch

from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh


def halo_exchange_1d(block: torch.Tensor, mesh: Optional[RankMesh], halo: int = 1,
                     periodic: bool = True) -> torch.Tensor:
    """Pad a block (..., n_local) of an axis(-1) sharded over sp with `halo`
    ghost cells from the ring neighbours: (..., halo + n_local + halo).

    With `periodic=False` the blocks at the two ends of the domain take
    clamped (edge-replicated) ghosts instead of the wrapped ones, the
    reference Keller-Segel boundary (KellerSegelSetup.jl:221-224). With one
    rank (no mesh, or sp = 1) the ring is the block itself."""
    n, idx = (1, 0) if mesh is None else (mesh.sp, mesh.sp_idx)
    edges = torch.stack([block[..., :halo], block[..., -halo:]])
    parts = [edges] if mesh is None else mesh.all_gather(edges, "sp")
    left_ghost = parts[(idx - 1) % n][1]  # the previous block's right edge
    right_ghost = parts[(idx + 1) % n][0]  # the next block's left edge
    if not periodic:
        if idx == 0:
            left_ghost = block[..., :1].expand_as(left_ghost)
        if idx == n - 1:
            right_ghost = block[..., -1:].expand_as(right_ghost)
    return torch.cat([left_ghost, block, right_ghost], dim=-1)
