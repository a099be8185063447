"""Spectral helpers: wavenumber operators and grids.

Counterpart of ``distributedconvrl_pde_control_tpu/ops/spectral.py``
(``ks_rfft_operators``, ``fft_wavenumbers``). Host-side NumPy: the solvers
compose these further before casting to float32.
"""

from __future__ import annotations

import numpy as np


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
