"""Kernel K3: the Keller-Segel finite-difference RK4 env step, and its wrapper.

Replaces no kernel of the JAX package, which steps Keller-Segel in XLA: K3
takes the place of the port's CUDA graph of the step's library kernels
(`ops/keller_segel.py`). The CUDA source is ``csrc/keller_segel_rk4.cu``
(its header comment gives the design and what bounds it); it is built with
nvcc for sm_90a at first use and called through a plain C interface. Its
plain version is the eager step, `KellerSegelSolver._rk4`, which the CPU runs
and which `KellerSegelSolver.step_eager` launches op by op on the card.

``KELLER_SEGEL_RK4(y, forcing, dt, oversampling, dx, chi)`` launches one env
step of (batch, 2, nx) float32 states on the current stream, or raises:
there is no fallback. It takes every nx from 1 to ``MAX_NX`` (a warp of 32
lanes holds an env, up to 8 points a lane).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

SOURCE = "keller_segel_rk4.cu"
MAX_NX = 32 * 8  # 32 lanes of at most 8 points: `ksg_rk4_max_nx` in the source
FLOPS_PER_POINT_SUBSTEP = 120  # 4 right-hand sides of 24, 3 stage inputs of 4, the sum's 12


@functools.lru_cache(maxsize=64)
def coefficients(dt: float, oversampling: int, dx: float, chi: float) -> tuple[float, ...]:
    """The kernel's float32 constants (1 / 2dx, 1 / dx^2, chi, h/2, h, h/6 with
    h = dt / oversampling), as the eager step forms them on the card: each
    product or quotient in double as Python forms it, rounded to float32; a
    division of a CUDA tensor by a scalar is a multiplication by the
    scalar's float32 reciprocal."""
    f32 = np.float32
    h = dt / oversampling
    return tuple(float(x) for x in (f32(1.0) / f32(2.0 * dx), f32(1.0) / f32(dx * dx), f32(chi),
                                    f32(0.5 * h), f32(h), f32(h / 6.0)))


def flops(batch: int, nx: int, oversampling: int) -> float:
    """Float32 operations of one env step as the equations are written
    (the source's header comment): the count K3's time is held against."""
    return float(FLOPS_PER_POINT_SUBSTEP * batch * nx * oversampling)


class _KellerSegelRK4:
    """Handle of the compiled kernel: lazy build, launch, launch count."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _load(self):
        if self._lib is None:
            from distributedconvrl_pde_control_torch.ops.kernels import build

            lib = build.load(SOURCE)
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ksg_rk4_launch.argtypes = [ptr] * 3 + [i32] * 3 + [f32] * 6 + [ptr]
            lib.ksg_rk4_launch.restype = ctypes.c_int
            lib.ksg_rk4_blocks_per_sm.argtypes = [i32, ctypes.POINTER(i32)]
            lib.ksg_rk4_blocks_per_sm.restype = ctypes.c_int
            lib.ksg_rk4_error_string.argtypes = [ctypes.c_int]
            lib.ksg_rk4_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, y: torch.Tensor, forcing: torch.Tensor, dt: float, oversampling: int,
                 dx: float, chi: float) -> torch.Tensor:
        if y.device.type != "cuda":
            raise RuntimeError(f"K3 launches on CUDA tensors only, got {y.device}")
        if y.dim() != 3 or y.shape[0] < 1 or y.shape[1] != 2 or not 1 <= y.shape[2] <= MAX_NX:
            raise ValueError(f"K3 y: need (batch >= 1, 2, nx) with 1 <= nx <= {MAX_NX}, "
                             f"got {tuple(y.shape)}")
        if oversampling < 1:
            raise ValueError(f"K3 needs oversampling >= 1, got {oversampling}")
        batch, _, nx = y.shape
        for name, t, shape in (("y", y, (batch, 2, nx)), ("forcing", forcing, (batch, nx))):
            if t.device != y.device or t.dtype != torch.float32:
                raise ValueError(f"K3 {name}: need float32 on {y.device}, "
                                 f"got {t.dtype} on {t.device}")
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"K3 {name}: need a contiguous {shape}, got {tuple(t.shape)}")
        lib = self._load()
        out = torch.empty_like(y)
        err = lib.ksg_rk4_launch(y.data_ptr(), forcing.data_ptr(), out.data_ptr(), batch, nx,
                                 oversampling, *coefficients(dt, oversampling, dx, chi),
                                 torch.cuda.current_stream(y.device).cuda_stream)
        if err:
            raise RuntimeError(f"K3 launch failed: {lib.ksg_rk4_error_string(err).decode()}")
        self.launches += 1
        return out


KELLER_SEGEL_RK4 = _KellerSegelRK4()
