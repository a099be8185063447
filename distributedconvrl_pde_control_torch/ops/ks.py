"""Kuramoto-Sivashinsky spectral CNAB2 stepper.

Counterpart of ``distributedconvrl_pde_control_tpu/ops/ks.py::KSSolver``.
Solves u_t = -u*u_x - u_xx - u_xxxx + forcing (+ mu*cos(...) disturbance) on
a periodic domain with the semantics of the reference's `do_step`
(`scripts/KS/setup/KSSetup.jl:130-160`): Crank-Nicolson for the linear term,
2nd-order Adams-Bashforth for the nonlinear term, `oversampling` substeps per
environment step. The step itself is kernel K1
(``ops/kernels/ks_kernel.py``): the CUDA kernel on CUDA tensors (all substeps
in one launch, on an in-kernel mixed-radix FFT whose stage plan and tables
the solver makes once, as ``kernel_constants``), its plain ``torch.fft``
version on CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributedconvrl_pde_control_torch.ops.kernels import ks_kernel
from distributedconvrl_pde_control_torch.ops.spectral import ks_rfft_operators


@dataclasses.dataclass(frozen=True)
class KSSolver:
    """Precomputed CNAB2 operators for one (nx, Lx, dt, oversampling) config
    on one device.

    The operators are composed host-side in float64 and cast to float32, as
    the reference solver does (KSSetup.jl:115-135). `mu` adds the
    inhomogeneous disturbance of KSSetup.jl:155:
    `dt_os * fft(mu * cos(2 + pi + x/(Lx/2)))`.
    """

    nx: int
    lx: float
    dt: float
    oversampling: int
    mu: float = 0.0
    device: str = "cuda"

    g_alpha: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    a_inv: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    b_op: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    dist_re: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    dist_im: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    kernel_constants: tuple = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        alpha, _, lin_op = ks_rfft_operators(self.nx, self.lx)
        dt_os = self.dt / self.oversampling
        dt2 = dt_os / 2.0
        # G = -0.5*D = -0.5i*alpha (KSSetup.jl:119), stored as the real
        # factor 0.5*alpha with the i folded into the component swap
        g_alpha = 0.5 * np.asarray(alpha, np.float64)
        lin = np.asarray(lin_op, np.float64)
        a_inv = 1.0 / (1.0 - dt2 * lin)
        b_op = 1.0 + dt2 * lin
        x = np.arange(1, self.nx + 1) * (self.lx / self.nx)
        dist_hat = np.fft.rfft(self.mu * np.cos(2.0 + np.pi + x / (self.lx / 2.0))) * dt_os

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

        for name, arr in (("g_alpha", g_alpha), ("a_inv", a_inv), ("b_op", b_op),
                          ("dist_re", dist_hat.real), ("dist_im", dist_hat.imag)):
            object.__setattr__(self, name, f32(arr))
        object.__setattr__(self, "kernel_constants", ks_kernel.kernel_constants(self))

    def step(self, y: torch.Tensor, forcing: torch.Tensor) -> torch.Tensor:
        """Advance real fields y (..., nx) by one env step (= `oversampling`
        substeps) under the real-space forcing p(x) (constant over the env
        step, as in the reference where env.p is fixed between actions)."""
        shape = y.shape
        y = y.to(torch.float32).reshape(-1, self.nx).contiguous()
        forcing = forcing.to(torch.float32).reshape(-1, self.nx).contiguous()
        return ks_kernel.ks_cnab2_step(y, forcing, self).reshape(shape)
