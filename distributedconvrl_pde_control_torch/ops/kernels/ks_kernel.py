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

Design. All substeps of an env step run in one launch with the spectra in
shared memory; the transforms are in-place mixed-radix FFTs on pairs of env
rows packed as one complex line. What the kernel needs of one grid size is
made here, on the host: the factors of nx in the order its stages run them
(``factor_radices``: butterflies of 4, 2, 3 and 5 in registers, any other
prime by a generic stage; the source pairs neighbouring butterflies into one
pass, 192 = (4*4)(4*3)), the digit-reversed positions its first load and
last store go through (``digit_reversed_positions``), the twiddle table and
the operator rows (``kernel_constants``), and how many row pairs and threads
a CTA takes (``launch_shape``).

What bounds it. Operations, not bytes: ``flops_per_row`` counts what the step
needs (62 real FFTs and the per-bin update) whatever transform runs, and
chip_smoke.py holds the kernel's time against that count.

Grid sizes. Every nx >= 2, even or odd (odd nx has no Nyquist bin: the split
and merge pair bins k and nx - k, and none is its own mirror but k = 0), by
one of two routes (``route``), both hand-written kernels of the same source:

  * "block", up to the grid whose CTA of one row pair still fits the card's
    shared memory (``line_limit``: 4,303, or 3,748 with a prime factor above
    5): the design above;
  * "device", above it: the half spectra and the work lines live in a
    workspace in device memory that the wrapper allocates and keeps per
    device, stream and shape, and every transform runs as levels that fit a
    block, a split of nx or Bluestein (``device_route.device_plan``), in one
    cooperative launch per env step.

The one grid refused is one whose workspace does not fit the device's free
memory; the error names the bytes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from distributedconvrl_pde_control_torch.ops.kernels import device_route

SOURCE = "ks_cnab2.cu"
REPLACES = "distributedconvrl_pde_control_tpu/ops/pallas/ks_kernel.py:96"
OPS_ROWS = 5  # a_inv, b, g_alpha, dist_re, dist_im
MAX_PAIRS = 8  # row pairs of a CTA: a quarter warp takes one pass task of 8 pairs
MAX_THREADS = 512
MAX_FACTORS = 16
BUTTERFLIES = (4, 2, 3, 5)  # radices the kernel runs in registers, in order of preference
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
SMEM_TARGET = 112_640  # what a CTA takes at most here where it can, so that two fit an SM
SMEM_PER_SM = 233_472  # an SM's shared memory; each resident CTA reserves 1 KB more than it asks
THREADS_PER_SM = 512  # threads an SM holds at the kernel's 128 registers per thread


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
def factor_radices(nx: int) -> list[int]:
    """The factors of nx as the kernel's stages run them: the butterflies it
    has (4, 2, 3, 5), then whatever primes remain, ascending."""
    radices, rest = [], nx
    for r in BUTTERFLIES:
        while rest % r == 0:
            radices.append(r)
            rest //= r
    p = 7
    while rest > 1:
        while rest % p == 0:
            radices.append(p)
            rest //= p
        p += 2
    return radices


def has_generic_stage(n: int) -> bool:
    """Whether a transform of length n runs a generic stage: a prime factor
    that is none of the butterflies, which runs out of place (a second
    line buffer in shared memory)."""
    return any(r not in BUTTERFLIES for r in factor_radices(n))


def digit_reversed_positions(nx: int, radices: list[int]) -> np.ndarray:
    """pos[j]: where the in-place decimation-in-frequency transform with
    these stages leaves output j (and where the decimation-in-time mirror
    expects input j): with j = j0 + r0*j1 + r0*r1*j2 + ..., position
    j0*nx/r0 + j1*nx/(r0*r1) + ..."""
    j = np.arange(nx)
    pos, span = np.zeros(nx, np.int64), nx
    for r in radices:
        span //= r
        pos += (j % r) * span
        j = j // r
    return pos.astype(np.int32)


def kernel_constants(solver):
    """What the kernel reads beside y and f: operator rows (5, nf) for the
    nf = nx//2+1 bins, the twiddle table (nx, 2), the position table (nx,)
    int32 on the solver's device, and the stage radices as a host int32
    array. Twiddles are cos/sin(2*pi*i/nx) in float64, cast to float32, with
    the exact zeros kept exact."""
    nx = solver.nx
    device = solver.a_inv.device
    ops = torch.stack([solver.a_inv, solver.b_op, solver.g_alpha, solver.dist_re,
                       solver.dist_im]).to(torch.float32).contiguous()
    ang = 2.0 * np.pi * np.arange(nx) / nx
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    tw[np.abs(tw) < 1e-12] = 0.0
    twiddle = torch.as_tensor(tw, dtype=torch.float32, device=device).contiguous()
    radices = factor_radices(nx)
    pos = torch.as_tensor(digit_reversed_positions(nx, radices), device=device)
    return ops, twiddle, pos, np.asarray(radices, dtype=np.int32)


def smem_bytes(nx: int, pairs: int, generic: bool = False) -> int:
    """Dynamic shared memory of one CTA (`smem_floats` in the source): three
    half spectra per row, one complex work line per pair (two where a stage
    runs out of place), the twiddle, operator and position tables."""
    nf = nx // 2 + 1
    return 4 * (12 * nf * pairs + 2 * nx * pairs * (2 if generic else 1) + 2 * nx
                + OPS_ROWS * nf + nx)


def line_limit(nx: int) -> int:
    """The largest grid of nx's kind (with or without a factor the kernel
    runs as a generic stage) whose CTA of one row pair fits the card's
    shared memory: ~54 B per point, ~62 with a generic stage."""
    generic = has_generic_stage(nx)
    m = 2
    while smem_bytes(m + 1, 1, generic) <= SMEM_LIMIT:
        m += 1
    return m


def route(nx: int) -> str:
    """"block" where a CTA of one row pair fits a block's shared memory
    (nx up to ``line_limit``), else "device"."""
    return "block" if smem_bytes(nx, 1, has_generic_stage(nx)) <= SMEM_LIMIT else "device"


def dm_work_floats(batch: int, nx: int, plan: device_route.DevicePlan) -> int:
    """Floats of the device route's workspace (`ks_cnab2_dm_work_floats` in
    the source): per row pair three half spectra of float4 and a work line,
    and Bluestein's work line of m points."""
    lines, nf = (batch + 1) // 2, nx // 2 + 1
    return lines * (12 * nf + 2 * nx + (2 * plan.m if plan.bluestein else 0))


def launch_shape(nx: int, batch: int) -> tuple[int, int]:
    """(row pairs per CTA, threads per CTA) for a batch at grid size nx: as
    many pairs as the batch has, up to 8, fewer where two CTAs would not
    fit an SM's shared memory; then the threads that fill an SM's registers
    with the CTAs its shared memory holds, at most four (at nx = 192, four
    CTAs of 8 pairs and 128 threads: measured faster than two of 16 pairs
    and 256 threads, and than any shape with more threads per SM than the
    registers hold)."""
    generic = has_generic_stage(nx)
    pairs, needed = MAX_PAIRS, (batch + 1) // 2
    while pairs > 1 and (smem_bytes(nx, pairs, generic) > SMEM_TARGET or pairs >= 2 * needed):
        pairs //= 2
    ctas = max(1, min(4, SMEM_PER_SM // (smem_bytes(nx, pairs, generic) + 1024)))
    tasks = pairs * (nx // 2 + 1)  # the spectral pass, the widest
    return pairs, max(32, min(THREADS_PER_SM // ctas // 32 * 32, _round_up(tasks, 32)))


def flops_per_row(nx: int, oversampling: int) -> float:
    """Float32 operations one env step needs per env row: the function's
    own count, whatever transform the kernel runs.

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
        # device route: (device, stream, batch, nx, SMEM_LIMIT) -> (plan, tables, workspace)
        self._plans = {}

    def _load(self):
        if self._lib is None:
            from distributedconvrl_pde_control_torch.ops.kernels import build

            lib = build.load(SOURCE)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.ks_cnab2_launch.argtypes = [ptr] * 6 + [i32] * 2 + [ptr] + [i32] * 4 + [
                ctypes.c_float, ptr]
            lib.ks_cnab2_launch.restype = ctypes.c_int
            lib.ks_cnab2_dm_launch.argtypes = [ptr] * 6 + [i32] + [ptr] * 4 + [i32] * 2 + [
                ctypes.c_float, ptr]
            lib.ks_cnab2_dm_launch.restype = ctypes.c_int
            lib.ks_cnab2_error_string.argtypes = [ctypes.c_int]
            lib.ks_cnab2_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, y: torch.Tensor, forcing: torch.Tensor, constants, oversampling: int,
                 dt: float) -> torch.Tensor:
        if y.device.type != "cuda":
            raise RuntimeError(f"K1 launches on CUDA tensors only, got {y.device}")
        ops, twiddle, pos, radices = constants
        batch, nx = y.shape
        if nx < 2 or batch < 1:
            raise ValueError(f"K1 needs nx >= 2 and batch >= 1, got {tuple(y.shape)}")
        nf = nx // 2 + 1
        for name, t, shape, dtype in (("y", y, (batch, nx), torch.float32),
                                      ("forcing", forcing, (batch, nx), torch.float32),
                                      ("ops", ops, (OPS_ROWS, nf), torch.float32),
                                      ("twiddle", twiddle, (nx, 2), torch.float32),
                                      ("pos", pos, (nx,), torch.int32)):
            if t.device != y.device or t.dtype != dtype:
                raise ValueError(f"K1 {name}: need {dtype} on {y.device}, got {t.dtype} on {t.device}")
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"K1 {name}: need a contiguous {shape}, got {tuple(t.shape)}")
        if radices.dtype != np.int32 or len(radices) > MAX_FACTORS or int(np.prod(radices)) != nx:
            raise ValueError(f"K1 radices: need at most {MAX_FACTORS} int32 factors of {nx}, "
                             f"got {radices}")
        lib = self._load()
        out = torch.empty_like(y)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        if route(nx) == "device":
            plan, (desc, tw, dpos, chirp, bh), work = self._device_plan(y.device, stream, batch, nx)
            ptr = device_route.ptr
            err = lib.ks_cnab2_dm_launch(
                y.data_ptr(), forcing.data_ptr(), ops.data_ptr(), out.data_ptr(), work.data_ptr(),
                desc.ctypes.data, len(desc), tw.data_ptr(), dpos.data_ptr(), ptr(chirp), ptr(bh),
                batch, oversampling, dt / oversampling, stream)
            if err:
                raise RuntimeError(f"K1 launch failed: {lib.ks_cnab2_error_string(err).decode()}")
            self.launches += 1
            return out
        pairs, threads = launch_shape(nx, batch)
        err = lib.ks_cnab2_launch(y.data_ptr(), forcing.data_ptr(), ops.data_ptr(),
                                  twiddle.data_ptr(), pos.data_ptr(), out.data_ptr(), batch, nx,
                                  radices.ctypes.data, len(radices), pairs.bit_length() - 1,
                                  threads, oversampling, dt / oversampling, stream)
        if err:
            raise RuntimeError(f"K1 launch failed: {lib.ks_cnab2_error_string(err).decode()}")
        self.launches += 1
        return out

    def _device_plan(self, device, stream, batch: int, nx: int):
        """The device route's plan, tables and workspace of one shape, made
        at its first call and kept; raises if they do not fit the device's
        memory."""
        key = (device.index, stream, batch, nx, SMEM_LIMIT)
        if key not in self._plans:
            plan = device_route.device_plan(nx, SMEM_LIMIT)
            floats = dm_work_floats(batch, nx, plan)
            device_route.check_memory(4 * floats + device_route.table_bytes(plan), device,
                                      f"K1 at nx={nx}, batch {batch}")
            self._plans[key] = (plan, device_route.device_tables(plan, device),
                                torch.empty(floats, dtype=torch.float32, device=device))
        return self._plans[key]


KS_CNAB2 = _KSCnab2Kernel()


def ks_cnab2_step(y: torch.Tensor, forcing: torch.Tensor, solver) -> torch.Tensor:
    """One KS env step of `solver` on (batch, nx) float32 tensors: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if y.device.type == "cpu":
        return ks_cnab2_plain(y, forcing, solver)
    return KS_CNAB2(y, forcing, solver.kernel_constants, solver.oversampling, solver.dt)
