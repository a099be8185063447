"""Kernel K1: the fused KS CNAB2 env step, its wrapper and its plain version.

Replaces ``distributedconvrl_pde_control_tpu/ops/pallas/ks_kernel.py::
KSPallasStepper._kernel``. The CUDA source is ``csrc/ks_cnab2.cu`` (its
header comment gives the design and what bounds it); it is built with nvcc
for sm_90a at first use and called through a plain C interface.

``ks_cnab2_step(y, forcing, solver)`` is the one entry point:

  * on CUDA tensors it launches the kernel (and counts the launch in
    ``KS_CNAB2.launches``) or raises: there is no fallback;
  * on CPU tensors it runs ``ks_cnab2_plain``, the same function in plain
    PyTorch (complex ``torch.fft`` in a Python loop of substeps).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

SOURCE = "ks_cnab2.cu"
REPLACES = "distributedconvrl_pde_control_tpu/ops/pallas/ks_kernel.py:96"
OPS_ROWS = 6  # a_inv, b, g_alpha, dist_re, dist_im, irdft weight
MAX_THREADS = 512
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ----------------------------------------------------------------- plain
def _apply_g(g_alpha: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """G*z with G = -0.5i*alpha, written as (0.5*alpha*zi, -0.5*alpha*zr)."""
    return torch.complex(g_alpha * z.imag, -g_alpha * z.real)


def ks_cnab2_plain(y: torch.Tensor, forcing: torch.Tensor, solver) -> torch.Tensor:
    """One env step of `solver` (a KSSolver) on y, forcing (batch, nx):
    `oversampling` CNAB2 substeps with complex torch.fft (KSSetup.jl:130-160)."""
    dt_os = solver.dt / solver.oversampling
    dt2 = dt_os / 2.0
    dt32 = 3.0 * dt_os / 2.0
    dist = torch.complex(solver.dist_re, solver.dist_im)
    u_hat = torch.fft.rfft(y)
    n_prev = _apply_g(solver.g_alpha, torch.fft.rfft(y * y))  # from y, KSSetup.jl:140-141
    f_hat = torch.fft.rfft(forcing) * dt_os
    for _ in range(solver.oversampling):
        u = torch.fft.irfft(u_hat, n=solver.nx)
        n_new = _apply_g(solver.g_alpha, torch.fft.rfft(u * u))
        # disturbance added outside the A_inv solve, as the reference does
        u_hat = solver.a_inv * (solver.b_op * u_hat + dt32 * n_new - dt2 * n_prev + f_hat) + dist
        n_prev = n_new
    return torch.fft.irfft(u_hat, n=solver.nx)


# ------------------------------------------------------------- constants
def kernel_constants(solver):
    """Operator rows (6, nfp) and twiddle table (nx, 2) the kernel reads.

    The half spectrum (nf = nx//2+1 bins) is padded to nfp, a multiple of
    4, with zero operators and zero irdft weights. The irdft weight is 1/nx
    at DC and Nyquist and 2/nx elsewhere. Twiddles are cos/sin(2*pi*i/nx)
    in float64, cast to float32, with the exact zeros kept exact (so the
    imaginary parts of the DC and Nyquist bins drop out as in irfft)."""
    nx = solver.nx
    nf = nx // 2 + 1
    nfp = _round_up(nf, 4)
    w = np.full(nf, 2.0 / nx)
    w[0] = 1.0 / nx
    if nx % 2 == 0:
        w[-1] = 1.0 / nx
    ops = torch.zeros(OPS_ROWS, nfp, dtype=torch.float32, device=solver.a_inv.device)
    for row, vec in enumerate((solver.a_inv, solver.b_op, solver.g_alpha,
                               solver.dist_re, solver.dist_im)):
        ops[row, :nf] = vec
    ops[5, :nf] = torch.as_tensor(w, dtype=torch.float32)
    ang = 2.0 * np.pi * np.arange(nx) / nx
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    tw[np.abs(tw) < 1e-12] = 0.0
    twiddle = torch.as_tensor(tw, dtype=torch.float32, device=ops.device).contiguous()
    return ops, twiddle


def smem_bytes(nx: int, rows: int) -> int:
    """Dynamic shared memory of one CTA: twiddles, operator rows, 6 half
    spectra and one real work row per env row (`smem_floats` in the source)."""
    nfp = _round_up(nx // 2 + 1, 4)
    return 4 * (2 * nx + OPS_ROWS * nfp + 6 * nfp * rows + nx * rows)


def launch_shape(nx: int, batch: int) -> tuple[int, int]:
    """(rows per CTA, threads per CTA) for a batch at grid size nx."""
    nfp = _round_up(nx // 2 + 1, 4)
    rows = 16
    while rows > 4 and smem_bytes(nx, rows) > SMEM_LIMIT:
        rows //= 2
    rows = min(rows, _round_up(batch, 4))
    tasks = max(nx // 4, nfp // 4) * (rows // 4)
    return rows, min(MAX_THREADS, _round_up(tasks, 32))


def flops_per_row(nx: int, oversampling: int) -> float:
    """Float32 operations one env step needs per env row: the function's
    own count, not what K1's direct DFTs spend (several times more).

    A real FFT of length nx is counted at 2.5*nx*log2(nx) flops. One step
    needs 2*oversampling+2 of them: rfft of y, y^2 and f; irfft + rfft of
    u^2 in substeps 2..oversampling (substep 1 has u = y, so its N is the
    N_prev from y^2); and the final irfft. The per-bin update (G, the CNAB2
    combination, A_inv, the disturbance) is ~14 flops per bin and substep,
    and squaring is 1 flop per point and substep."""
    nf = nx // 2 + 1
    fft = 2.5 * nx * np.log2(nx)
    return (2 * oversampling + 2) * fft + oversampling * (14 * nf + nx)


# --------------------------------------------------------------- wrapper
class _KSCnab2Kernel:
    """Handle of the compiled kernel: lazy build, launch, launch count."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _load(self):
        if self._lib is None:
            from distributedconvrl_pde_control_torch.ops.kernels import build

            lib = build.load(SOURCE)
            lib.ks_cnab2_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_float, ctypes.c_void_p]
            lib.ks_cnab2_launch.restype = ctypes.c_int
            lib.ks_cnab2_error_string.argtypes = [ctypes.c_int]
            lib.ks_cnab2_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, y: torch.Tensor, forcing: torch.Tensor, ops: torch.Tensor,
                 twiddle: torch.Tensor, oversampling: int, dt: float) -> torch.Tensor:
        if y.device.type != "cuda":
            raise RuntimeError(f"K1 launches on CUDA tensors only, got {y.device}")
        batch, nx = y.shape
        if nx % 4 or batch < 1:
            raise ValueError(f"K1 needs nx % 4 == 0 and batch >= 1, got {tuple(y.shape)}")
        nfp = _round_up(nx // 2 + 1, 4)
        for name, t, shape in (("y", y, (batch, nx)), ("forcing", forcing, (batch, nx)),
                               ("ops", ops, (OPS_ROWS, nfp)), ("twiddle", twiddle, (nx, 2))):
            if t.device != y.device or t.dtype != torch.float32:
                raise ValueError(f"K1 {name}: need float32 on {y.device}, got {t.dtype} on {t.device}")
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"K1 {name}: need a contiguous {shape}, got {tuple(t.shape)}")
        lib = self._load()
        rows, threads = launch_shape(nx, batch)
        out = torch.empty_like(y)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.ks_cnab2_launch(y.data_ptr(), forcing.data_ptr(), ops.data_ptr(),
                                  twiddle.data_ptr(), out.data_ptr(), batch, nx, nfp,
                                  rows, threads, oversampling, dt / oversampling, stream)
        if err:
            raise RuntimeError(f"K1 launch failed: {lib.ks_cnab2_error_string(err).decode()}")
        self.launches += 1
        return out


KS_CNAB2 = _KSCnab2Kernel()


def ks_cnab2_step(y: torch.Tensor, forcing: torch.Tensor, solver) -> torch.Tensor:
    """One KS env step of `solver` on (batch, nx) float32 tensors: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if y.device.type == "cpu":
        return ks_cnab2_plain(y, forcing, solver)
    ops, twiddle = solver.kernel_constants
    return KS_CNAB2(y, forcing, ops, twiddle, solver.oversampling, solver.dt)
