"""Fourier transforms of the spectral solvers: ``torch.fft`` or dense DFT
products at the JAX package's reduced-precision tiers.

Counterpart of ``distributedconvrl_pde_control_tpu/ops/fourier.py``: the
call surface through which the solvers transform. `mode` chooses per call:

- ``"auto"`` and ``"native"``: complex ``torch.fft`` in float32 (cuFFT on the
  card, pocketfft on the CPU), the JAX package's ``mode="auto"`` off a TPU;
- ``"matmul"``: the float32 DFT matrices of the JAX package, one float32
  product per transformed axis with TF32 off (XLA's ``Precision.HIGHEST``);
- ``"matmul_fast"``: both operands rounded to bfloat16 (round to nearest
  even), the products formed exactly and summed in float32, the result
  float32 (``Precision.DEFAULT``: one bf16 pass);
- ``"matmul_hi"``: each operand split as ``x = x_hi + x_lo``, ``x_hi =
  bf16(x)``, ``x_lo = bf16(x - x_hi)``, and ``x_hi M_hi + x_hi M_lo + x_lo
  M_hi`` summed in float32 (``Precision.HIGH``: three bf16 passes).

How. The split operands are bf16-representable values kept in float32
storage. A float32 product of such values is exact, so the three passes are
one product of depth 3n: ``[x_hi | x_hi | x_lo] @ [M_hi; M_lo; M_hi]``. On
the card that product runs as a TF32 GEMM (cuBLAS): TF32 holds a bf16 value
exactly and accumulates in float32, so the card computes the TPU's rounding
on its tensor cores; the TF32 switch is set around the DFT product only and
restored after it, and every other product of the port stays float32. On
the CPU the same call is a float32 GEMM, an exact emulation. The two devices
differ only in the order of the float32 sums. The output is never rounded
to bf16.

Each axis is one product: complex data enter as their interleaved (re, im)
float32 view, so a complex transform along the last axis is one product
with a real (2n, 2n) matrix; along the axis before it the data multiply
``[C; S]`` from the left. The matrices are the JAX package's (built in
float64, cast to float32, the inverse real transform's Hermitian weights
folded in before the cast) and are cached with their splits per length,
tier and device. Inverse complex transforms divide by n after the product,
as the JAX package does. The ``*_ri`` forms keep the JAX package's
(re, im) pair interface.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

TIERS = ("matmul", "matmul_hi", "matmul_fast")


def use_matmul_dft(mode: str) -> bool:
    """True for the DFT-product tiers, False for ``torch.fft``; raises
    ValueError for any other mode."""
    if mode in ("auto", "native"):
        return False
    if mode in TIERS:
        return True
    raise ValueError(f"unknown fft mode {mode!r}: expected 'auto', 'native' or one of {TIERS}")


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bfloat16 (ties to even), kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _operand(x: torch.Tensor, mode: str, dim: int, matrix: bool = False) -> torch.Tensor:
    """One side of a tier product, split along its contraction axis `dim`:
    the data side of matmul_hi is [hi | hi | lo], the matrix side [hi; lo; hi]."""
    if mode == "matmul":
        return x
    hi = _bf16_round(x)
    if mode == "matmul_fast":
        return hi
    lo = _bf16_round(x - hi)
    return torch.cat([hi, lo, hi] if matrix else [hi, hi, lo], dim)


@contextlib.contextmanager
def _cublas_fp32(tf32: bool):
    """cuBLAS's float32 precision set to TF32 (or to IEEE float32) inside the
    block and restored after it, through torch's `fp32_precision` (the
    legacy `allow_tf32` must not be mixed in: its getter raises once the
    new API has set the precision)."""
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    m.fp32_precision = "tf32" if tf32 else "ieee"
    try:
        yield
    finally:
        m.fp32_precision = prev


def _gemm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b of two tier operands: TF32 on the card for the bf16 tiers, IEEE
    float32 for matmul; a float32 product on the CPU."""
    if a.device.type != "cuda":
        return torch.matmul(a, b)
    with _cublas_fp32(mode != "matmul"):
        return torch.matmul(a, b)


# ------------------------------------------------------------- the matrices
@functools.lru_cache(maxsize=None)
def _dft_mats_np(n: int):
    """cos/sin DFT matrices: C[j,k] = cos(2 pi j k / n), S[j,k] = sin(...)."""
    jk = np.outer(np.arange(n), np.arange(n)) * (2.0 * np.pi / n)
    return np.cos(jk).astype(np.float32), np.sin(jk).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rdft_mats_np(n: int):
    """Real-input forward matrices to the half spectrum (n//2+1 bins)."""
    jk = np.outer(np.arange(n), np.arange(n // 2 + 1)) * (2.0 * np.pi / n)
    return np.cos(jk).astype(np.float32), np.sin(jk).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _irdft_mats_np(n: int):
    """Half spectrum -> real signal synthesis matrices with the Hermitian
    doubling weights (1 for DC and Nyquist, 2 otherwise, all /n)."""
    nf = n // 2 + 1
    kj = np.outer(np.arange(nf), np.arange(n)) * (2.0 * np.pi / n)
    w = np.full((nf, 1), 2.0 / n)
    w[0] = 1.0 / n
    if n % 2 == 0:
        w[-1] = 1.0 / n
    return (np.cos(kj) * w).astype(np.float32), (np.sin(kj) * w).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _matrix(kind: str, n: int, mode: str, device: str) -> torch.Tensor:
    """The float32 matrix of one transform of length n, split for `mode`, on
    `device`. Right-multiplied kinds map interleaved (re, im) rows to
    interleaved columns: "rdft" real -> half spectrum, "irdft" half spectrum
    -> real, "fwd"/"inv" complex -> complex (sign -1/+1), "fwd_real" real ->
    complex; "cs" is [C; S], which multiplies data along their -2 axis from
    the left."""
    if kind == "rdft":  # re = y C, im = -(y S)
        c, s = _rdft_mats_np(n)
        m = np.stack([c, -s], -1).reshape(n, -1)
    elif kind == "irdft":  # y = re Ci - im Si
        ci, si = _irdft_mats_np(n)
        m = np.stack([ci, -si], 1).reshape(-1, n)
    elif kind in ("fwd", "inv", "fwd_real"):  # zr = xr C - sign xi S, zi = xi C + sign xr S
        sign = 1.0 if kind == "inv" else -1.0
        c, s = _dft_mats_np(n)
        m = np.empty((n, 2, n, 2), np.float32)
        m[:, 0, :, 0], m[:, 0, :, 1] = c, sign * s
        m[:, 1, :, 0], m[:, 1, :, 1] = -sign * s, c
        m = m[:, 0].reshape(n, 2 * n) if kind == "fwd_real" else m.reshape(2 * n, 2 * n)
    elif kind == "cs":
        m = np.concatenate(_dft_mats_np(n))
    else:
        raise ValueError(f"unknown DFT matrix kind {kind!r}")
    t = torch.as_tensor(np.ascontiguousarray(m), dtype=torch.float32, device=device)
    return _operand(t, mode, 1 if kind == "cs" else 0, matrix=True).contiguous()


def _right(a: torch.Tensor, kind: str, n: int, mode: str) -> torch.Tensor:
    """Real (..., k) data (a complex tensor as its interleaved view) times the
    right-multiplied matrix of `kind`: one product."""
    if a.is_complex():
        a = torch.view_as_real(a.to(torch.complex64)).flatten(-2)
    a = a.to(torch.float32)
    return _gemm(_operand(a, mode, -1), _matrix(kind, n, mode, str(a.device)), mode)


def _left(x: torch.Tensor, sign: float, mode: str) -> torch.Tensor:
    """The complex DFT of x (..., n, cols) along its -2 axis (sign -1
    forward, +1 inverse with the 1/n): [C; S] times the interleaved data as
    one product, then zr = Cxr - sign Sxi and zi = Cxi + sign Sxr."""
    n = x.shape[-2]
    v = torch.view_as_real(x.to(torch.complex64)).movedim(-3, 0)  # (n, ..., cols, 2)
    p = _gemm(_matrix("cs", n, mode, str(x.device)),
              _operand(v.reshape(n, -1), mode, 0), mode).view(2, *v.shape)
    c, s = p[0], p[1]
    out = torch.stack([torch.add(c[..., 0], s[..., 1], alpha=-sign),
                       torch.add(c[..., 1], s[..., 0], alpha=sign)], -1)
    if sign > 0:
        out = out.div_(n)
    return torch.view_as_complex(out.movedim(0, -3))


def _cdft(x: torch.Tensor, axis: int, sign: float, mode: str) -> torch.Tensor:
    """The complex DFT of real or complex x along `axis` at a tier."""
    axis = axis % x.ndim
    if axis == x.ndim - 1:
        n = x.shape[-1]
        kind = "inv" if sign > 0 else "fwd" if x.is_complex() else "fwd_real"
        if sign > 0 and not x.is_complex():
            x = x.to(torch.complex64)
        y = _right(x, kind, n, mode)
        if sign > 0:
            y = y.div_(n)
        return torch.view_as_complex(y.unflatten(-1, (n, 2)))
    return _left(x.movedim(axis, -2), sign, mode).movedim(-2, axis)


# ------------------------------------------------------------------ 1D real
def rfft(y: torch.Tensor, axis: int = -1, mode: str = "auto") -> torch.Tensor:
    if not use_matmul_dft(mode):
        return torch.fft.rfft(y, dim=axis)
    y = y.movedim(axis, -1)
    h = _right(y, "rdft", y.shape[-1], mode)
    return torch.view_as_complex(h.unflatten(-1, (-1, 2))).movedim(-1, axis)


def irfft(h: torch.Tensor, n: int, axis: int = -1, mode: str = "auto") -> torch.Tensor:
    if not use_matmul_dft(mode):
        return torch.fft.irfft(h, n=n, dim=axis)
    return _right(h.movedim(axis, -1), "irdft", n, mode).movedim(-1, axis)


# --------------------------------------------------------------- 1D complex
def fft(x: torch.Tensor, axis: int = -1, mode: str = "auto") -> torch.Tensor:
    if not use_matmul_dft(mode):
        return torch.fft.fft(x, dim=axis)
    return _cdft(x, axis, -1.0, mode)


def ifft(x: torch.Tensor, axis: int = -1, mode: str = "auto") -> torch.Tensor:
    if not use_matmul_dft(mode):
        return torch.fft.ifft(x, dim=axis)
    return _cdft(x, axis, 1.0, mode)


# ----------------------------------------------------------------------- 2D
def fft2(x: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """2D forward transform over the last two axes (at a tier: axis -1, then -2)."""
    if not use_matmul_dft(mode):
        return torch.fft.fft2(x)
    return _cdft(_cdft(x, -1, -1.0, mode), -2, -1.0, mode)


def ifft2(x: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """2D inverse transform over the last two axes (at a tier: axis -1, then -2)."""
    if not use_matmul_dft(mode):
        return torch.fft.ifft2(x)
    return _cdft(_cdft(x, -1, 1.0, mode), -2, 1.0, mode)


def rfft2(x: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """Real field (..., ny, nx) -> complex half spectrum (..., ny, nx//2+1):
    the real transform along -1, then the complex one along -2."""
    if not use_matmul_dft(mode):
        return torch.fft.rfft2(x)
    return _cdft(rfft(x, mode=mode), -2, -1.0, mode)


def irfft2(h: torch.Tensor, nx: int, mode: str = "auto") -> torch.Tensor:
    """Complex half spectrum (..., ny, nx//2+1) -> real field (..., ny, nx):
    the complex inverse along -2, then the real one along -1."""
    if not use_matmul_dft(mode):
        return torch.fft.irfft2(h, s=(h.shape[-2], nx))
    return irfft(_cdft(h, -2, 1.0, mode), nx, mode=mode)


# ----------------------------------------------------- real/imag pair API
def rfft_ri(y: torch.Tensor, mode: str = "auto"):
    """Real signal -> (re, im) half-spectrum along the last axis."""
    h = rfft(y, mode=mode)
    return h.real, h.imag


def irfft_ri(re: torch.Tensor, im: torch.Tensor, n: int, mode: str = "auto") -> torch.Tensor:
    """(re, im) half-spectrum -> real signal of length n along the last axis."""
    return irfft(torch.complex(re, im), n, mode=mode)


def _fft_ri_axis(xr: torch.Tensor, xi: torch.Tensor, axis: int, sign: float, mode: str):
    """(xr + i xi) transformed along `axis`; sign -1 forward, +1 inverse
    (the inverse includes the 1/n)."""
    z = torch.complex(xr, xi)
    z = fft(z, axis=axis, mode=mode) if sign < 0 else ifft(z, axis=axis, mode=mode)
    return z.real, z.imag


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
    h = rfft2(x, mode=mode)
    return h.real, h.imag


def irfft2_ri_real(re: torch.Tensor, im: torch.Tensor, nx: int, mode: str = "auto") -> torch.Tensor:
    """(re, im) half-spectrum -> real field (ifft along -2, irfft along -1)."""
    return irfft2(torch.complex(re, im), nx, mode=mode)
