"""2D Navier-Stokes vorticity solver with 2/3-rule de-aliasing.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/ns_sharded.py``
(``ShardedOps``, ``make_sharded_ops``, ``NSShardedSolver`` and
``NSShardedSolverRI``). The reference shards each field over a mesh axis
and de-aliases by the elementwise 2/3-rule mask instead of the 3/2-rule
padding of the single-device solver; this port runs the same scheme for a
group of one rank, where the block is the whole field. The state is the REAL
vorticity field (B, n, n) as in the reference; inside a step the solver
carries complex64 spectra (the reference's (re, im) float32 pairs are one
complex tensor here, so one class serves both reference classes).

Design. Every Runge-Kutta stage is one launch of kernel K2
(``ops/kernels/ns_advection.py``) with the stage arithmetic folded in: the
stage state ``w + alpha * k_prev`` is formed where the kernel reads,
``-nu k^2 ws + advection(ws) + forcing`` is what its last pass writes, and
the fourth stage writes the combined substep
``w + dt/6 (k1 + 2 (k2 + k3) + k4)``. An RK4 substep is four launches of
the kernel and no other, and all substeps of an env step are launched by one
call into the kernel's library (``ns_rk4_substeps``), so the host's work per
env step does not grow with the substep count. The integrating-factor tier,
whose stage states carry exp factors, calls ``ns_advection`` once per stage
with the forcing as its operand. On CPU tensors the same calls run the
kernel's plain version: ``torch.fft`` and the same arithmetic in PyTorch.
The boundary transforms of a step run at `fft_mode` (``parallel/dfft.py``
over ``ops/fourier.py``). The advection is K2 in float32 under every
`nl_fft_mode`, as its Pallas twin is HIGHEST only (``ns_advection.py:40``);
the reference's sharded path rounds it at the nonlinear tier.

What bounds it. The device, and in it K2: at one env a stage is a chain of
dependent passes over an L2-resident field (its bytes alone would take under
a microsecond), at 16 envs the line transforms' shared-memory traffic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributedconvrl_pde_control_torch.ops.kernels.ns_advection import (
    AdvectionConstants,
    advection_constants,
    ns_advection,
    ns_rk4_substeps,
)
from distributedconvrl_pde_control_torch.ops import fourier
from distributedconvrl_pde_control_torch.ops.spectral import fft_wavenumbers
from distributedconvrl_pde_control_torch.parallel.dfft import dfft2, difft2_real


# The reference's ShardedOps (kx, ky, k2, inv_k2, mask23 in full (ny, nx)
# shape, float32) is the constants object of kernel K2, which holds the same
# arrays beside the vectors and the twiddle table that the kernel reads.
ShardedOps = AdvectionConstants


def make_sharded_ops(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0,
                     device: str = "cuda") -> ShardedOps:
    """Operators of an (ny, nx) grid; kx, ky are cast to float32 before k^2
    is formed, as the reference does. Kernel K2 takes square grids."""
    if nx != ny:
        raise ValueError(f"the advection kernel takes square grids, got nx={nx}, ny={ny}")
    return advection_constants(fft_wavenumbers(nx, lx), fft_wavenumbers(ny, ly), device)


@dataclasses.dataclass(frozen=True)
class NSShardedSolver:
    """RK4 vorticity stepper on spectra (semantics of the reference's
    NSShardedSolver / NSShardedSolverRI for one rank).

    Spectra are complex64 (B, n, n); the arithmetic around the kernel calls
    (the integrating factors, the adaptive stepper's error) runs on their
    interleaved float32 views so that real operators multiply both
    components without a complex product. `fft_mode` is the tier of the
    boundary transforms; `nl_fft_mode` is validated and kept for the
    reference's interface, and the advection (K2) computes in float32."""

    nu: float
    fft_mode: str = "auto"
    nl_fft_mode: str | None = None

    def __post_init__(self):
        fourier.use_matmul_dft(self.fft_mode)  # an unknown mode raises here
        fourier.use_matmul_dft(self.nl_fft_mode or self.fft_mode)

    # ------------------------------------------------------------ spectra
    def _rhs_v(self, wv, fv, ops: ShardedOps, lin):
        """rhs on float views (B, n, n, 2): lin * w + advection(w) + f, with
        lin = -nu k^2 (n, n), or None for the integrating-factor tier: one
        call of kernel K2."""
        return torch.view_as_real(ns_advection(torch.view_as_complex(wv), ops, lin=lin,
                                               f=torch.view_as_complex(fv)))

    def _lin(self, ops: ShardedOps):
        return -self.nu * ops.k2

    def rhs(self, w, forcing_hat, ops: ShardedOps):
        """-nu k^2 w + advection(w) + forcing_hat on complex spectra."""
        return ns_advection(w.contiguous(), ops, lin=self._lin(ops), f=forcing_hat.contiguous())

    def _rk4_substep_v(self, wv, fv, ops, dt, lin):
        """w + dt/6 (k1 + 2 (k2 + k3) + k4) on float views (B, n, n, 2):
        four launches of kernel K2."""
        return torch.view_as_real(ns_rk4_substeps(
            torch.view_as_complex(wv), ops, lin, torch.view_as_complex(fv), dt))

    def rk4_substep(self, w, forcing_hat, ops: ShardedOps, dt):
        """One classical RK4 substep of length dt on complex spectra."""
        return ns_rk4_substeps(w.contiguous(), ops, self._lin(ops), forcing_hat.contiguous(), dt)

    # --------------------------------------------------------- real fields
    def _to_spectra(self, omg, forcing):
        shape = omg.shape
        n2 = shape[-2:]

        def fwd(x):
            return torch.view_as_real(dfft2(x.to(torch.float32).reshape(-1, *n2),
                                            mode=self.fft_mode).contiguous())

        return fwd(omg), fwd(forcing), shape

    def _to_field(self, w, shape):
        return difft2_real(w, mode=self.fft_mode).reshape(shape)

    def step_real(self, omg, forcing, ops: ShardedOps, dt, oversampling: int):
        """REAL field (..., n, n) -> advanced real field: `oversampling` RK4
        substeps under a forcing held constant over the step (the
        reference's do_step, FluidSetup.jl:163-172)."""
        dt_os = dt / oversampling
        wv, fv, shape = self._to_spectra(omg, forcing)
        w = ns_rk4_substeps(torch.view_as_complex(wv), ops, self._lin(ops),
                            torch.view_as_complex(fv), dt_os, oversampling)
        return self._to_field(w, shape)

    def step_real_if(self, omg, forcing, ops: ShardedOps, dt, oversampling: int):
        """Integrating-factor RK4 tier: the viscous diagonal is integrated
        exactly by elementwise exp factors, so the substep count is set by
        the advective limit alone."""
        dt_os = dt / oversampling
        e_half = torch.exp((-self.nu * ops.k2) * (dt_os / 2.0))[..., None]
        e_full = e_half * e_half
        wv, fv, shape = self._to_spectra(omg, forcing)

        def n_of(zv):
            return self._rhs_v(zv.contiguous(), fv, ops, None)

        for _ in range(oversampling):
            k1 = n_of(wv)
            k2 = n_of(e_half * (wv + 0.5 * dt_os * k1))
            k3 = n_of(e_half * wv + 0.5 * dt_os * k2)
            k4 = n_of(e_full * wv + dt_os * e_half * k3)
            wv = e_full * wv + dt_os / 6.0 * (e_full * k1 + 2.0 * e_half * (k2 + k3) + k4)
        return self._to_field(torch.view_as_complex(wv.contiguous()), shape)

    def step_real_adaptive(self, omg, forcing, ops: ShardedOps, dt, rtol: float = 1.0,
                           atol: float = 1.0, max_steps: int = 256):
        """do_step2: step-doubling adaptive RK4 (FluidSetup.jl:181-186) over
        one env step. A trial of length h is taken once whole and once as
        two halves; it is accepted when max |y_two - y_full| / (atol + rtol
        |y_two|) <= 15, the maximum running over the whole batch, so all
        envs share the step sequence, as the envs of one dp group do in the
        reference. The time and step-size scalars live on the host in
        float32, as the reference carries them on the device; each trial
        reads its error back, which is the loop's one synchronisation."""
        f32 = np.float32
        wv, fv, shape = self._to_spectra(omg, forcing)
        lin = self._lin(ops)
        t, h, n = f32(0.0), f32(dt / 16.0), 0
        t_end, t_stop = f32(dt), f32(dt * (1 - 1e-12))
        while t < t_stop and n < max_steps:
            h = min(h, t_end - t)
            y_full = self._rk4_substep_v(wv, fv, ops, float(h), lin)
            y_half = self._rk4_substep_v(wv, fv, ops, float(h / f32(2.0)), lin)
            y_two = self._rk4_substep_v(y_half, fv, ops, float(h / f32(2.0)), lin)
            diff = y_two - y_full
            err = f32((diff.abs() / (atol + rtol * y_two.abs())).max().item())
            err = max(err, f32(1e-12))
            if err <= 15.0:  # RK4 step-doubling factor (2^4 - 1)
                wv = y_two + diff / 15.0
                t = t + h
            h = h * f32(np.clip(f32(0.9) * (f32(15.0) / err) ** f32(0.2), 0.2, 5.0))
            n += 1
        return self._to_field(torch.view_as_complex(wv), shape)


# the reference's complex-free twin: one class serves both here
NSShardedSolverRI = NSShardedSolver

