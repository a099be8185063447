"""2D FFTs of spatially sharded fields, for a group of one rank.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/dfft.py``. The
reference shards a field over a mesh axis `sp` (rows in real space, columns
in wave space) and transforms by the transpose method. With one rank the
block is the whole field and the transform is ``ops/fourier.py``'s `fft2` /
`ifft2` at `mode` (``torch.fft`` at "auto", the DFT-product tiers
otherwise: axis -1, then -2, as the reference's local transforms run) on
complex64 spectra; the reference's (re, im) split variants fold into these.
The transpose method over more than one rank (`torch.distributed`) is not
ported yet.
"""

from __future__ import annotations

import torch

from distributedconvrl_pde_control_torch.ops import fourier


def _one_rank(world_size: int):
    if world_size != 1:
        raise NotImplementedError(
            f"the transpose-method FFT over {world_size} ranks is ROADMAP.md queue 1 item 15; "
            "the port transforms whole fields on one rank")


def dfft2(x_block: torch.Tensor, world_size: int = 1, mode: str = "auto") -> torch.Tensor:
    """Real or complex field block (..., ny, nx) -> full spectrum (..., ny, nx) complex."""
    _one_rank(world_size)
    return fourier.fft2(x_block, mode=mode)


def difft2(w_block: torch.Tensor, world_size: int = 1, mode: str = "auto") -> torch.Tensor:
    """Spectrum (..., ny, nx) -> complex field; take `.real` at the call
    site for real fields, or use `difft2_real`."""
    _one_rank(world_size)
    return fourier.ifft2(w_block, mode=mode)


def difft2_real(w_block: torch.Tensor, world_size: int = 1, mode: str = "auto") -> torch.Tensor:
    """Real part of the full complex inverse (the reference's
    `difft2_ri_real`: the imaginary part is dropped, not assumed zero)."""
    return difft2(w_block, world_size, mode).real
