"""Kuramoto-Sivashinsky spectral steppers: CNAB2 and ETDRK4.

Counterpart of ``distributedconvrl_pde_control_tpu/ops/ks.py`` (``KSSolver``,
``KSSolverETDRK4``). Both solve u_t = -u*u_x - u_xx - u_xxxx + forcing (+ mu*cos(...) disturbance) on
a periodic domain with the semantics of the reference's `do_step`
(`scripts/KS/setup/KSSetup.jl:130-160`): Crank-Nicolson for the linear term,
2nd-order Adams-Bashforth for the nonlinear term, `oversampling` substeps per
environment step. The CNAB2 step itself is kernel K1
(``ops/kernels/ks_kernel.py``): the CUDA kernel on CUDA tensors (all substeps
in one launch, on an in-kernel mixed-radix FFT whose stage plan and tables
the solver makes once, as ``kernel_constants``; above nx = 4,303 the
kernel's device route, whose plan, tables and workspace the wrapper makes at
first use), its plain ``torch.fft`` version on CPU tensors. K1 computes in float32 whatever transform tier
the config names, as its Pallas twin does (HIGHEST only, ``ks_kernel.py:102``);
the JAX package's non-Pallas ``KSSolver`` would round at the tier there. The
ETDRK4 stepper has no hand kernel in either package: it transforms through
``ops/fourier.py`` at its `fft_mode` / `nl_fft_mode` (``torch.fft`` at
"auto", the DFT-product tiers otherwise) and carries the half-spectrum as
one complex64 tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributedconvrl_pde_control_torch.ops import fourier
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


@dataclasses.dataclass(frozen=True)
class KSSolverETDRK4:
    """ETDRK4 stepper for the same KS equation: the throughput integrator
    (not in the reference, whose do_step is CNAB2 with 30 substeps,
    KSSetup.jl:130-160).

    Exponential time differencing treats the stiff linear operator
    exp(h(k^2 - k^4)) exactly, so the step size is limited only by the
    advection nonlinearity: one h=dt step (4 nonlinear evaluations = 8
    transforms) replaces CNAB2's 30 substeps (60 transforms). The
    phi-function weights are computed host-side in float64 with the
    Kassam-Trefethen (2005) contour integral, the standard cure for the
    cancellation in (e^z - 1)/z, and cast to float32.

    The half-spectrum (..., nx//2+1) is one complex64 tensor wherever it is
    carried (`init_carry`, `step_spectral`, `step_spectral_only`). Drop-in
    `.step(y, forcing)` interface; every method takes leading batch dims.

    `fft_mode` is the tier of the boundary transforms (`step`, `init_carry`
    and the synthesis of `_advance`), `nl_fft_mode` that of the eight
    transforms per substep inside the nonlinear term (None: `fft_mode`);
    ETDRK4 multiplies every nonlinear result by the O(h) phi-weights, so a
    cheaper tier's error enters the state scaled by them.
    """

    nx: int
    lx: float
    dt: float
    oversampling: int = 1  # substeps per env step (1 suffices for KS22)
    mu: float = 0.0
    fft_mode: str = "auto"
    nl_fft_mode: str | None = None
    device: str = "cuda"

    e_full: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    e_half: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    q_w: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    f1_w: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    f2_w: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    f3_w: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    g_alpha: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    dist_re: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    dist_im: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    f2_twice: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    g_op: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    dist: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        fourier.use_matmul_dft(self.fft_mode)  # an unknown mode raises here
        fourier.use_matmul_dft(self.nl_mode)
        alpha, _, lin = ks_rfft_operators(self.nx, self.lx)
        lin = np.asarray(lin, np.float64)
        h = self.dt / self.oversampling
        e_full = np.exp(h * lin)
        e_half = np.exp(h * lin / 2.0)
        # Kassam-Trefethen contour quadrature for the phi weights
        m = 32
        r = np.exp(1j * np.pi * (np.arange(1, m + 1) - 0.5) / m)
        lr = h * lin[:, None] + r[None, :]
        elr = np.exp(lr)
        q = h * np.real(np.mean((np.exp(lr / 2.0) - 1.0) / lr, axis=1))
        f1 = h * np.real(np.mean(
            (-4.0 - lr + elr * (4.0 - 3.0 * lr + lr**2)) / lr**3, axis=1))
        f2 = h * np.real(np.mean(
            (2.0 + lr + elr * (-2.0 + lr)) / lr**3, axis=1))
        f3 = h * np.real(np.mean(
            (-4.0 - 3.0 * lr - lr**2 + elr * (4.0 - lr)) / lr**3, axis=1))
        g_alpha = 0.5 * np.asarray(alpha, np.float64)
        x = np.arange(1, self.nx + 1) * (self.lx / self.nx)
        dist_hat = np.fft.rfft(self.mu * np.cos(2.0 + np.pi + x / (self.lx / 2.0)))
        for name, arr in (("e_full", e_full), ("e_half", e_half), ("q_w", q),
                          ("f1_w", f1), ("f2_w", f2), ("f3_w", f3),
                          ("g_alpha", g_alpha),
                          ("dist_re", dist_hat.real), ("dist_im", dist_hat.imag)):
            object.__setattr__(self, name, torch.as_tensor(
                np.asarray(arr, np.float32), device=self.device))
        # 2*f2 (exact in float32), G = -0.5i*alpha and the disturbance as complex rows
        object.__setattr__(self, "f2_twice", 2.0 * self.f2_w)
        object.__setattr__(self, "g_op", torch.complex(torch.zeros_like(self.g_alpha),
                                                       -self.g_alpha))
        object.__setattr__(self, "dist", torch.complex(self.dist_re, self.dist_im))

    @property
    def nl_mode(self) -> str:
        return self.nl_fft_mode or self.fft_mode

    def step(self, y: torch.Tensor, forcing: torch.Tensor) -> torch.Tensor:
        """One env step (= `oversampling` ETDRK4 steps). Forcing (+ the
        mu-disturbance) is constant over the env step and enters the
        nonlinear term additively, like the reference's CNAB2 treats it."""
        v = fourier.rfft(y.to(torch.float32), mode=self.fft_mode)
        f_hat = fourier.rfft(forcing.to(torch.float32), mode=self.fft_mode)
        return self._advance(v, f_hat)[1]

    def init_carry(self, y: torch.Tensor) -> torch.Tensor:
        """Spectral-carry API: the complex64 half-spectrum of `y`, to be
        threaded through `step_spectral` across env steps (configs/ks.py
        spectral_carry tier)."""
        return fourier.rfft(y.to(torch.float32), mode=self.fft_mode)

    def step_spectral(self, carry: torch.Tensor, f_hat: torch.Tensor):
        """One env step on the spectral carry: `carry', y' = step(...)`.

        Same math as `step` minus the two boundary analysis transforms: the
        state stays in spectral space between env steps, and the forcing
        arrives as a half-spectrum computed directly from the actions via
        pre-transformed actuator kernels (exact, since the forcing is a
        linear combination of fixed kernels, KSSetup.jl:231-245). Only the
        one synthesis transform per env step remains, feeding featurize,
        reward and blow-up termination their real-space field."""
        return self._advance(carry, f_hat)

    def step_spectral_only(self, carry: torch.Tensor, f_hat: torch.Tensor) -> torch.Tensor:
        """`step_spectral` minus the final synthesis transform, for the
        spectral-featurize tier, where featurize, reward and blow-up
        termination consume the carried half-spectrum directly."""
        return self._advance_spectral(carry, f_hat)

    def _advance(self, carry, f_hat):
        """`oversampling` ETDRK4 substeps from spectral state + spectral
        forcing; returns (new carry, real-space field)."""
        v = self._advance_spectral(carry, f_hat)
        return v, fourier.irfft(v, self.nx, mode=self.fft_mode)

    def _advance_spectral(self, v, f_hat):
        """The spectral-state advance shared by step/step_spectral[_only]."""
        f_hat = f_hat + self.dist
        nx, g, mode = self.nx, self.g_op, self.nl_mode

        def nonlin(z):
            u = fourier.irfft(z, nx, mode=mode)
            return g * fourier.rfft(u * u, mode=mode) + f_hat  # G*s plus the constant forcing

        for _ in range(self.oversampling):
            nv = nonlin(v)
            ev = self.e_half * v
            a = ev + self.q_w * nv
            na = nonlin(a)
            b = ev + self.q_w * na
            nb = nonlin(b)
            c = self.e_half * a + self.q_w * (2.0 * nb - nv)
            nc = nonlin(c)
            v = self.e_full * v + self.f1_w * nv + self.f2_twice * (na + nb) + self.f3_w * nc
        return v
