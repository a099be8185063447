"""Fourier transforms of the spectral solvers, on complex ``torch.fft``.

Counterpart of ``distributedconvrl_pde_control_tpu/ops/fourier.py``: the
call surface through which the JAX package's ``NSSolver`` and Keller-Segel
solvers transform. The JAX package chooses per call between XLA's FFT and
matmul DFTs on the MXU (`mode`); here every transform is cuFFT on the card
and pocketfft on the CPU, in float32, which is the JAX package's
``mode="auto"`` off a TPU. The ``*_ri`` forms keep the JAX package's
(re, im) pair interface; inside they are one complex transform each. The
port's ``NSSolver`` calls ``torch.fft`` on its complex spectra directly;
``KellerSegelSpectralLegacy`` goes through this module. The
reduced-precision matmul tiers (``matmul``, ``matmul_hi``,
``matmul_fast``) are ROADMAP.md queue 1 item 16.
"""

from __future__ import annotations

import torch


def _check(mode: str) -> None:
    if mode not in ("auto", "native"):
        raise NotImplementedError(
            f"fft mode {mode!r}: the matmul DFT tiers are ROADMAP.md queue 1 item 16; the port "
            "runs mode='auto' (float32 FFTs) only")


# ------------------------------------------------------------------ 1D real
def rfft(y: torch.Tensor, axis: int = -1, mode: str = "auto") -> torch.Tensor:
    _check(mode)
    return torch.fft.rfft(y, dim=axis)


def irfft(h: torch.Tensor, n: int, axis: int = -1, mode: str = "auto") -> torch.Tensor:
    _check(mode)
    return torch.fft.irfft(h, n=n, dim=axis)


# --------------------------------------------------------------- 1D complex
def fft(x: torch.Tensor, axis: int = -1, mode: str = "auto") -> torch.Tensor:
    _check(mode)
    return torch.fft.fft(x, dim=axis)


def ifft(x: torch.Tensor, axis: int = -1, mode: str = "auto") -> torch.Tensor:
    _check(mode)
    return torch.fft.ifft(x, dim=axis)


# ----------------------------------------------------------------------- 2D
def fft2(x: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    _check(mode)
    return torch.fft.fft2(x)


def ifft2(x: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    _check(mode)
    return torch.fft.ifft2(x)


# ----------------------------------------------------- real/imag pair API
def rfft_ri(y: torch.Tensor, mode: str = "auto"):
    """Real signal -> (re, im) half-spectrum along the last axis."""
    h = rfft(y, mode=mode)
    return h.real, h.imag


def irfft_ri(re: torch.Tensor, im: torch.Tensor, n: int, mode: str = "auto") -> torch.Tensor:
    """(re, im) half-spectrum -> real signal of length n along the last axis."""
    return irfft(torch.complex(re, im), n, mode=mode)


def fft2_ri(xr: torch.Tensor, xi=None, mode: str = "auto"):
    """2D forward transform of xr + i xi (xi None = real input)."""
    z = fft2(xr if xi is None else torch.complex(xr, xi), mode=mode)
    return z.real, z.imag


def ifft2_ri(xr: torch.Tensor, xi: torch.Tensor, mode: str = "auto"):
    z = ifft2(torch.complex(xr, xi), mode=mode)
    return z.real, z.imag


def ifft2_ri_real(xr: torch.Tensor, xi: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """Real part of the 2D inverse transform (for Hermitian spectra)."""
    return ifft2_ri(xr, xi, mode)[0]


# ------------------------------------------------- 2D real (half-spectrum)
def rfft2_ri(x: torch.Tensor, mode: str = "auto"):
    """Real field (..., ny, nx) -> (re, im) half-spectrum (..., ny, nx//2+1)."""
    _check(mode)
    h = torch.fft.rfft2(x)
    return h.real, h.imag


def irfft2_ri_real(re: torch.Tensor, im: torch.Tensor, nx: int, mode: str = "auto") -> torch.Tensor:
    """(re, im) half-spectrum -> real field (ifft along -2, irfft along -1)."""
    _check(mode)
    return torch.fft.irfft2(torch.complex(re, im), s=(re.shape[-2], nx))
