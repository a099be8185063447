"""Kernel K2: the NS advection term with the 2/3-rule mask, its wrapper, its
constants and its plain version.

Replaces ``distributedconvrl_pde_control_tpu/ops/pallas/ns_advection.py::
PallasAdvection2D._kernel``. The CUDA source is ``csrc/ns_advection.cu``
(its header comment gives the design and what bounds it); it is built with
nvcc for sm_90a at first use and called through a plain C interface.

``ns_advection(w, consts)`` is the one entry point, for w (B, n, n)
complex64 full spectra indexed [ky][kx]:

  * on a CUDA tensor it launches the kernel chain (and counts the call in
    ``NS_ADVECTION.launches``) or raises: there is no fallback, and no
    ``torch.fft`` or matrix product on that path;
  * on a CPU tensor it runs ``ns_advection_plain``, the same function with
    complex ``torch.fft``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

SOURCE = "ns_advection.cu"
REPLACES = "distributedconvrl_pde_control_tpu/ops/pallas/ns_advection.py:70"
FIELDS = 4  # u, v, dw/dx, dw/dy: the scratch holds one complex field each
MIN_N, MAX_N = 8, 1024
TILE_POINTS = 4096  # complex points of a column tile in shared memory (32 KB)


# ------------------------------------------------------------- constants
@dataclasses.dataclass(frozen=True)
class AdvectionConstants:
    """Spectral operator arrays of one square grid on one device.

    kx varies along the last axis and ky along rows, (n, n) float32 each,
    as the reference solver holds them; `kx_vec`, `ky_vec` (n,) and the
    twiddle table (n/2, 2) are what the kernel reads beside `inv_k2` and
    `mask23`."""

    n: int
    kx: torch.Tensor
    ky: torch.Tensor
    k2: torch.Tensor
    inv_k2: torch.Tensor  # 0 at k = 0
    mask23: torch.Tensor  # 2/3 rule: 1 where |k_int| <= n//3 on both axes
    kx_vec: torch.Tensor
    ky_vec: torch.Tensor
    twiddle: torch.Tensor


def advection_constants(kx: np.ndarray, ky: np.ndarray, device="cuda") -> AdvectionConstants:
    """Constants from the wavenumber vectors kx, ky (n,) of a square grid.

    The vectors are cast to float32 before k^2 is formed, as the reference
    does (`make_sharded_ops`, `PallasAdvection2D._consts`); the sign of the
    Nyquist entry is the caller's convention."""
    n = len(kx)
    if len(ky) != n:
        raise ValueError(f"K2 takes square grids, got kx ({len(kx)},) and ky ({len(ky)},)")
    kx_row = np.broadcast_to(np.asarray(kx)[None, :], (n, n)).astype(np.float32)
    ky_col = np.broadcast_to(np.asarray(ky)[:, None], (n, n)).astype(np.float32)
    k2 = ky_col**2 + kx_row**2
    inv_k2 = (1.0 / np.where(k2 == 0.0, 1.0, k2)).astype(np.float32)
    inv_k2[k2 == 0.0] = 0.0
    ii = np.abs(np.fft.fftfreq(n) * n)
    mask = ((ii[:, None] <= n // 3) & (ii[None, :] <= n // 3)).astype(np.float32)
    ang = 2.0 * np.pi * np.arange(n // 2) / n
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    return AdvectionConstants(n=n, kx=dev(kx_row), ky=dev(ky_col), k2=dev(k2), inv_k2=dev(inv_k2),
                              mask23=dev(mask), kx_vec=dev(kx_row[0]), ky_vec=dev(ky_col[:, 0]),
                              twiddle=dev(twiddle))


def fftfreq_constants(n: int, lx: float = 1.0, device="cuda") -> AdvectionConstants:
    """The constants of `PallasAdvection2D._consts` (np.fft.fftfreq
    wavenumbers: the Nyquist entry is negative)."""
    k = (2.0 * np.pi * np.fft.fftfreq(n, d=lx / n)).astype(np.float32)
    return advection_constants(k, k, device)


# ----------------------------------------------------------------- plain
def ns_advection_plain(w: torch.Tensor, c: AdvectionConstants) -> torch.Tensor:
    """The advection term of w (..., n, n) complex64 with complex torch.fft.

    Full complex inverses with the real part taken, as the reference does
    (the signed Nyquist wavenumber stays in the derivatives), not
    irfft2/rfft2."""
    wr, wi = w.real, w.imag
    pr, pi = c.inv_k2 * wr, c.inv_k2 * wi
    u = torch.fft.ifft2(torch.complex(-c.ky * pi, c.ky * pr)).real
    v = torch.fft.ifft2(torch.complex(c.kx * pi, -c.kx * pr)).real
    dwdx = torch.fft.ifft2(torch.complex(-c.kx * wi, c.kx * wr)).real
    dwdy = torch.fft.ifft2(torch.complex(-c.ky * wi, c.ky * wr)).real
    return torch.fft.fft2(-u * dwdx - v * dwdy) * c.mask23


def column_tile(n: int) -> int:
    """Columns per block of the two column passes."""
    return max(1, min(8, TILE_POINTS // n))


def flops(n: int, batch: int) -> float:
    """Float32 operations the function needs. The four inverse transforms
    keep only their real parts and the forward transform takes a real field,
    so two complex inverses of packed pairs and one real-to-complex forward
    suffice: 2.5 complex 2D FFTs at 5*N*log2(N) flops for N = n*n points,
    plus ~30 flops per point for the spectral multiplies, the product and
    the mask. (The kernel itself runs five full complex transforms.)"""
    points = n * n
    return batch * (2.5 * 5.0 * points * np.log2(points) + 30.0 * points)


def min_bytes(n: int, batch: int) -> int:
    """Bytes the function must move: w read once, out written once."""
    return 16 * batch * n * n


# --------------------------------------------------------------- wrapper
class _NSAdvectionKernel:
    """Handle of the compiled kernel chain: lazy build, launch, call count."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _load(self):
        if self._lib is None:
            from distributedconvrl_pde_control_torch.ops.kernels import build

            lib = build.load(SOURCE)
            lib.ns_advection_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            lib.ns_advection_launch.restype = ctypes.c_int
            lib.ns_advection_error_string.argtypes = [ctypes.c_int]
            lib.ns_advection_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, w: torch.Tensor, c: AdvectionConstants) -> torch.Tensor:
        if w.device.type != "cuda":
            raise RuntimeError(f"K2 launches on CUDA tensors only, got {w.device}")
        n = c.n
        if n < MIN_N or n > MAX_N or n & (n - 1):
            raise ValueError(f"K2's line transform takes n a power of two in "
                             f"[{MIN_N}, {MAX_N}], got {n}")
        if w.dtype != torch.complex64 or w.dim() != 3 or tuple(w.shape[1:]) != (n, n) \
                or w.shape[0] < 1 or not w.is_contiguous():
            raise ValueError(f"K2 w: need a contiguous complex64 (B, {n}, {n}), "
                             f"got {w.dtype} {tuple(w.shape)}")
        for name, t, shape in (("kx_vec", c.kx_vec, (n,)), ("ky_vec", c.ky_vec, (n,)),
                               ("inv_k2", c.inv_k2, (n, n)), ("mask23", c.mask23, (n, n)),
                               ("twiddle", c.twiddle, (n // 2, 2))):
            if t.device != w.device or t.dtype != torch.float32:
                raise ValueError(f"K2 {name}: need float32 on {w.device}, got {t.dtype} on {t.device}")
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"K2 {name}: need a contiguous {shape}, got {tuple(t.shape)}")
        lib = self._load()
        batch = w.shape[0]
        out = torch.empty_like(w)
        scratch = torch.empty((batch, FIELDS, n, n), dtype=torch.complex64, device=w.device)
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.ns_advection_launch(
            w.data_ptr(), c.kx_vec.data_ptr(), c.ky_vec.data_ptr(), c.inv_k2.data_ptr(),
            c.mask23.data_ptr(), c.twiddle.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            batch, n, n.bit_length() - 1, column_tile(n), stream)
        if err:
            raise RuntimeError(f"K2 launch failed: {lib.ns_advection_error_string(err).decode()}")
        self.launches += 1
        return out


NS_ADVECTION = _NSAdvectionKernel()


def ns_advection(w: torch.Tensor, c: AdvectionConstants) -> torch.Tensor:
    """The masked advection term of the spectra w (B, n, n) complex64: the
    CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if w.device.type == "cpu":
        return ns_advection_plain(w, c)
    return NS_ADVECTION(w, c)
