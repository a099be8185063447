"""Spectral helpers: wavenumber operators and grids.

Counterpart of ``distributedconvrl_pde_control_tpu/ops/spectral.py``
(``ks_rfft_operators``, ``fft_wavenumbers``, and the 3/2-rule re-gridding
``pad_32``, ``chop_32``, ``pad_32_half``, ``chop_32_half`` over leading
batch axes). The operators are host-side NumPy: the solvers compose them
further before casting to float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def ks_rfft_operators(nx: int, lx: float):
    """1D wavenumber operators on the rfft half-spectrum (length nx//2+1).

    Returns (alpha, d_op, lin_op):
      alpha  - real wavenumbers 2*pi*k/Lx with the Nyquist entry zeroed,
               mirroring the reference's `kx = [0:nx/2-1, 0, -nx/2+1:-1]`
               (KSSetup.jl:115-116);
      d_op   - d/dx in Fourier space, `1im*alpha` (KSSetup.jl:117);
      lin_op - the KS linear operator `alpha^2 - alpha^4` = -D^2 - D^4
               (KSSetup.jl:118).
    """
    k = np.arange(nx // 2 + 1, dtype=np.float64)
    k[-1] = 0.0  # zero the Nyquist mode, as the reference does
    alpha = 2.0 * np.pi * k / lx
    d_op = 1j * alpha
    lin_op = alpha**2 - alpha**4
    return (
        alpha.astype(np.float32),
        d_op.astype(np.complex64),
        lin_op.astype(np.float32),
    )


def fft_wavenumbers(n: int, length: float) -> np.ndarray:
    """Full-spectrum wavenumbers [0..n/2, -n/2+1..-1] * 2*pi/length.

    Matches `kx = [0:(nx/2); (-nx/2+1):(-1)]/Lx*2*pi` at FluidSetup.jl:106
    (signed Nyquist kept, and positive, unlike `np.fft.fftfreq`).
    """
    k = np.concatenate([np.arange(0, n // 2 + 1), np.arange(-n // 2 + 1, 0)])
    return k * 2.0 * np.pi / length


# ------------------------------------------------------ 3/2-rule re-gridding
# Each map is one precomputed gather over the flattened (ny, nx) plane: the
# padded spectrum's slots index the small one (pad), or the other way round
# (chop). The Nyquist row and column (index n/2) belong to the positive
# block, as in the reference (fluid_rk4.jl:192-229); the negative block
# starts at n/2 + 1. Grids are even.
def _pad_rows(n: int, n_pad: int) -> np.ndarray:
    """For each index of a padded axis of length n_pad, the index of the
    short axis (length n) it copies, or -1 in the zero band."""
    n2 = n // 2
    src = np.full(n_pad, -1, np.int64)
    src[: n2 + 1] = np.arange(n2 + 1)
    src[n_pad - n2 + 1:] = np.arange(n2 + 1, n)
    return src


def _chop_rows(n: int, n_pad: int) -> np.ndarray:
    """For each index of a short axis (length n), the padded index it reads."""
    n2 = n // 2
    return np.concatenate([np.arange(n2 + 1), np.arange(n_pad - n2 + 1, n_pad)])


@functools.lru_cache(maxsize=None)
def _pad_index(ny: int, nx: int, nyp: int, nxp: int, half: bool, device: str):
    """(flat gather index into the small plane, clamped; keep mask) of a pad."""
    rows = _pad_rows(ny, nyp)
    cols = np.where(np.arange(nxp) < nx, np.arange(nxp), -1) if half else _pad_rows(nx, nxp)
    keep = (rows[:, None] >= 0) & (cols[None, :] >= 0)
    idx = np.where(keep, rows[:, None] * nx + cols[None, :], 0).reshape(-1)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(keep.reshape(-1), device=device))


@functools.lru_cache(maxsize=None)
def _chop_index(ny: int, nx: int, nyp: int, nxp: int, half: bool, device: str):
    """Flat gather index into the padded plane of a chop."""
    rows = _chop_rows(ny, nyp)
    cols = np.arange(nx) if half else _chop_rows(nx, nxp)
    return torch.as_tensor((rows[:, None] * nxp + cols[None, :]).reshape(-1), device=device)


def pad_index(ny: int, nx: int, nyp: int, nxp: int, half: bool = False, device="cpu"):
    """The gather of `pad_32` (`half=False`, full (ny, nx) spectra) or
    `pad_32_half` (`half=True`, (ny, nx) the half-spectrum's own shape):
    (index into the flattened small plane, mask of the slots that keep a
    value), each of nyp * nxp entries."""
    return _pad_index(ny, nx, nyp, nxp, half, str(torch.device(device)))


def chop_index(ny: int, nx: int, nyp: int, nxp: int, half: bool = False, device="cpu"):
    """The gather of `chop_32` (`half=False`) or `chop_32_half` (`half=True`,
    (ny, nx) and (nyp, nxp) the half-spectra's own shapes): the index into the
    flattened padded plane of each of the ny * nx slots."""
    return _chop_index(ny, nx, nyp, nxp, half, str(torch.device(device)))


def _pad(f: torch.Tensor, nyp: int, nxp: int, half: bool) -> torch.Tensor:
    ny, nx = f.shape[-2:]
    idx, keep = pad_index(ny, nx, nyp, nxp, half, f.device)
    g = f.flatten(-2).index_select(-1, idx)
    return torch.where(keep, g, torch.zeros((), dtype=f.dtype, device=f.device)).unflatten(
        -1, (nyp, nxp))


def _chop(fp: torch.Tensor, ny: int, nx: int, half: bool) -> torch.Tensor:
    nyp, nxp = fp.shape[-2:]
    idx = chop_index(ny, nx, nyp, nxp, half, fp.device)
    return fp.flatten(-2).index_select(-1, idx).unflatten(-1, (ny, nx))


def pad_32(f: torch.Tensor, nyp: int, nxp: int) -> torch.Tensor:
    """3/2-rule zero padding of (..., ny, nx) spectra to (..., nyp, nxp)
    (semantics of fluid_rk4.jl:192-210): the four low-frequency quadrants
    are kept, the high-frequency band is zero."""
    return _pad(f, nyp, nxp, half=False)


def chop_32(fp: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Inverse of `pad_32`: drop the high-frequency band (fluid_rk4.jl:212-229)."""
    return _chop(fp, ny, nx, half=False)


def pad_32_half(f: torch.Tensor, nyp: int, nxp: int) -> torch.Tensor:
    """3/2-rule padding of half spectra (..., ny, nx//2+1) -> (..., nyp,
    nxp//2+1): the x axis holds the non-negative wavenumbers only and is
    extended with zeros, the y axis splits as in `pad_32`."""
    return _pad(f, nyp, nxp // 2 + 1, half=True)


def chop_32_half(fp: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Inverse of `pad_32_half`: (..., nyp, nxp//2+1) -> (..., ny, nx//2+1)."""
    return _chop(fp, ny, nx // 2 + 1, half=True)
