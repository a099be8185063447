"""2D FFTs of spatially sharded fields by the transpose method.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/dfft.py``. A
field is sharded over the mesh axis sp of S ranks:

  * real space, "y-pencil": each rank holds a block (..., ny/S, nx) of rows;
  * wave space, "x-pencil": each rank holds a block (..., ny, nx/S) of columns.

`dfft2` transforms along x (the rows are whole), exchanges blocks with one
tiled `all_to_all` over sp (`RankMesh.all_to_all`), and transforms along y;
`difft2` is its inverse. Local transforms run at `mode` on
``ops/fourier.py`` (``torch.fft`` at "auto", the DFT-product tiers
otherwise). Spectra are complex64: the reference's (re, im) split variants
fold into these functions, and a complex block crosses the group as its
float32 view. With one rank on sp (no mesh, or sp = 1) the block is the
whole field and the transform is ``fourier.fft2`` / ``ifft2``: the exchange
with oneself is the identity and is left out, as XLA leaves it out.
"""

from __future__ import annotations

from typing import Optional

import torch

from distributedconvrl_pde_control_torch.ops import fourier
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh


def _sharded(mesh: Optional[RankMesh]) -> bool:
    return mesh is not None and mesh.sp > 1


def dfft2(x_block: torch.Tensor, mesh: Optional[RankMesh] = None,
          mode: str = "auto") -> torch.Tensor:
    """y-pencil field block (..., ny/S, nx), real or complex -> x-pencil
    spectrum (..., ny, nx/S), complex64."""
    if not _sharded(mesh):
        return fourier.fft2(x_block, mode=mode)
    xh = fourier.fft(x_block, axis=-1, mode=mode)
    xh = mesh.all_to_all(xh, "sp", split_axis=-1, concat_axis=-2)
    return fourier.fft(xh, axis=-2, mode=mode)


def difft2(w_block: torch.Tensor, mesh: Optional[RankMesh] = None,
           mode: str = "auto") -> torch.Tensor:
    """x-pencil spectrum (..., ny, nx/S) -> y-pencil complex field block
    (..., ny/S, nx); take `.real` at the call site for real fields, or use
    `difft2_real`."""
    if not _sharded(mesh):
        return fourier.ifft2(w_block, mode=mode)
    x = fourier.ifft(w_block, axis=-2, mode=mode)
    x = mesh.all_to_all(x, "sp", split_axis=-2, concat_axis=-1)
    return fourier.ifft(x, axis=-1, mode=mode)


def difft2_real(w_block: torch.Tensor, mesh: Optional[RankMesh] = None,
                mode: str = "auto") -> torch.Tensor:
    """Real part of the full complex inverse (the reference's
    `difft2_ri_real`: the imaginary part is dropped, not assumed zero)."""
    return difft2(w_block, mesh, mode).real
