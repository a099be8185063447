"""2D Navier-Stokes vorticity solver with 2/3-rule de-aliasing, on fields
sharded over the ranks of sp.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/ns_sharded.py``
(``ShardedOps``, ``make_sharded_ops``, ``NSShardedSolver`` and
``NSShardedSolverRI``). The reference shards each field over a mesh axis sp
and de-aliases by the elementwise 2/3-rule mask instead of the 3/2-rule
padding of the single-device solver. The state is the REAL vorticity field
as in the reference, a y-pencil block (B, n/S, n) per rank; inside a step
the solver carries complex64 spectra, x-pencil blocks (B, n, n/S) (the
reference's (re, im) float32 pairs are one complex tensor here, so one class
serves both reference classes).

Design at sp = 1 (no mesh, or a mesh whose sp group has one rank: every
rank of a dp-only mesh, and the card's 1x1). Every Runge-Kutta stage is one
launch of kernel K2 (``ops/kernels/ns_advection.py``) with the stage
arithmetic folded in: the stage state ``w + alpha * k_prev`` is formed where
the kernel reads, ``-nu k^2 ws + advection(ws) + forcing`` is what its last
pass writes, and the fourth stage writes the combined substep
``w + dt/6 (k1 + 2 (k2 + k3) + k4)``. An RK4 substep is four launches of
the kernel and no other, and all substeps of an env step are launched by one
call into the kernel's library (``ns_rk4_substeps``), so the host's work per
env step does not grow with the substep count. The integrating-factor tier,
whose stage states carry exp factors, calls ``ns_advection`` once per stage
with the forcing as its operand. On CPU tensors the same calls run the
kernel's plain version: ``torch.fft`` and the same arithmetic in PyTorch.
The advection is K2 in float32 under every `nl_fft_mode`, as its Pallas
twin is HIGHEST only (``ns_advection.py:40``).

Design at sp > 1. K2 transforms whole fields and a rank holds n/S rows, so
the advection is the reference's transpose method (JAX
``ns_sharded.py:117-135``, which is XLA, not Pallas): the operators are the
rank's x-pencil column slices (`PencilOps`), the four inverse transforms of
u, v, dw/dx and dw/dy run as one stacked `difft2_real` (one `all_to_all`
for the four), the product is formed on the y-pencil block, and one forward
`dfft2` and the 2/3 mask on the local columns close it, at `nl_fft_mode`.
The stage arithmetic runs on the spectra's float32 views.

In both designs the boundary transforms of a step run at `fft_mode`
(``parallel/dfft.py`` over ``ops/fourier.py``), and the adaptive stepper's
acceptance error is `pmax`'d over sp before the host reads it, so that every
rank of an sp group takes the same trials.

What bounds it at sp = 1. The device, and in it K2: at one env a stage is a
chain of dependent passes over an L2-resident field (its bytes alone would
take under a microsecond), at 16 envs the line transforms' shared-memory
traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

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
from distributedconvrl_pde_control_torch.parallel.mesh import RankMesh


@dataclasses.dataclass(frozen=True)
class PencilOps:
    """The operators' x-pencil column slices (n, n/S) float32 of one rank
    at sp > 1: the reference's ShardedOps as `P(None, 'sp')` hands them out."""

    kx: torch.Tensor
    ky: torch.Tensor
    k2: torch.Tensor
    inv_k2: torch.Tensor
    mask23: torch.Tensor


# The reference's ShardedOps (kx, ky, k2, inv_k2, mask23 in full (ny, nx)
# shape, float32) is, at sp = 1, the constants object of kernel K2, which
# holds the same arrays beside the vectors and the twiddle table that the
# kernel reads; at sp > 1 a rank holds their column slices.
ShardedOps = Union[AdvectionConstants, PencilOps]


def _sp(mesh: Optional[RankMesh]) -> int:
    return 1 if mesh is None else mesh.sp


def make_sharded_ops(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0, device: str = "cuda",
                     mesh: Optional[RankMesh] = None) -> ShardedOps:
    """Operators of an (ny, nx) grid; kx, ky are cast to float32 before k^2
    is formed, as the reference does. At sp = 1 the constants of kernel K2,
    which takes square grids of any size (its device route above one block's
    shared memory), made on `device` from the wavenumber vectors: at 6144^2
    each (n, n) array is 151 MB there and no host array of that size is
    built; at sp > 1 this rank's column slices."""
    if nx != ny:
        raise ValueError(f"the advection kernel takes square grids, got nx={nx}, ny={ny}")
    consts = advection_constants(fft_wavenumbers(nx, lx), fft_wavenumbers(ny, ly), device)
    s = _sp(mesh)
    if s == 1:
        return consts
    if nx % s:
        raise ValueError(f"the grid's {nx} columns do not divide over sp={s}")
    cols = slice(mesh.sp_idx * nx // s, (mesh.sp_idx + 1) * nx // s)
    return PencilOps(*(getattr(consts, k)[:, cols].contiguous()
                       for k in ("kx", "ky", "k2", "inv_k2", "mask23")))


@dataclasses.dataclass(frozen=True)
class NSShardedSolver:
    """RK4 vorticity stepper on spectra (semantics of the reference's
    NSShardedSolver / NSShardedSolverRI), on the ranks of `mesh`'s sp group
    (None: one rank).

    Spectra are complex64, (B, n, n) at sp = 1 and (B, n, n/S) x-pencil
    blocks at sp > 1; the arithmetic around the transforms and kernel calls
    (the integrating factors, the adaptive stepper's error, at sp > 1 the
    stages) runs on their interleaved float32 views so that real operators
    multiply both components without a complex product. `fft_mode` is the
    tier of the boundary transforms; `nl_fft_mode` that of the advection's
    transforms at sp > 1 (at sp = 1 it is validated and kept for the
    reference's interface, and K2 computes in float32)."""

    nu: float
    fft_mode: str = "auto"
    nl_fft_mode: str | None = None
    mesh: Optional[RankMesh] = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        fourier.use_matmul_dft(self.fft_mode)  # an unknown mode raises here
        fourier.use_matmul_dft(self.nl_fft_mode or self.fft_mode)

    @property
    def sharded(self) -> bool:
        return _sp(self.mesh) > 1

    # ------------------------------------------------------------ spectra
    def _advection_pencil(self, w, ops: PencilOps):
        """The masked advection term of x-pencil spectra (B, n, n/S): four
        inverse transforms stacked into one, the product on the y-pencil
        block, one forward transform, the mask on the local columns."""
        nl = self.nl_fft_mode or self.fft_mode
        psih = w * ops.inv_k2
        u, v, dwdx, dwdy = difft2_real(
            torch.stack([1j * psih * ops.ky, -1j * psih * ops.kx, 1j * w * ops.kx,
                         1j * w * ops.ky]), self.mesh, nl)
        return dfft2(-u * dwdx - v * dwdy, self.mesh, nl) * ops.mask23

    def _rhs_v(self, wv, fv, ops: ShardedOps, lin):
        """rhs on float views (B, n, n/S, 2): lin * w + advection(w) + f,
        with lin = -nu k^2, or None for the integrating-factor tier. At
        sp = 1 one call of kernel K2."""
        w, f = torch.view_as_complex(wv), torch.view_as_complex(fv)
        if not self.sharded:
            return torch.view_as_real(ns_advection(w, ops, lin=lin, f=f))
        out = torch.view_as_real(self._advection_pencil(w, ops))
        if lin is not None:
            out = torch.addcmul(out, lin[..., None], wv)
        return out + fv

    def _lin(self, ops: ShardedOps):
        return -self.nu * ops.k2

    def rhs(self, w, forcing_hat, ops: ShardedOps):
        """-nu k^2 w + advection(w) + forcing_hat on complex spectra."""
        return torch.view_as_complex(self._rhs_v(torch.view_as_real(w.contiguous()),
                                                 torch.view_as_real(forcing_hat.contiguous()),
                                                 ops, self._lin(ops)))

    def _rk4_substeps_v(self, wv, fv, ops, dt, lin, substeps: int):
        """`substeps` RK4 substeps on float views: at sp = 1 all launched by
        one call into kernel K2's library, four launches each."""
        if not self.sharded:
            return torch.view_as_real(ns_rk4_substeps(
                torch.view_as_complex(wv), ops, lin, torch.view_as_complex(fv), dt, substeps))
        for _ in range(substeps):
            wv = self._rk4_substep_v(wv, fv, ops, dt, lin)
        return wv

    def _rk4_substep_v(self, wv, fv, ops, dt, lin):
        """w + dt/6 (k1 + 2 (k2 + k3) + k4) on float views (B, n, n/S, 2): at
        sp = 1 four launches of kernel K2."""
        if not self.sharded:
            return self._rk4_substeps_v(wv, fv, ops, dt, lin, 1)
        k1 = self._rhs_v(wv, fv, ops, lin)
        k2 = self._rhs_v(torch.add(wv, k1, alpha=0.5 * dt), fv, ops, lin)
        k3 = self._rhs_v(torch.add(wv, k2, alpha=0.5 * dt), fv, ops, lin)
        k4 = self._rhs_v(torch.add(wv, k3, alpha=dt), fv, ops, lin)
        return torch.add(wv, (k1 + (k2 + k3).mul_(2.0)).add_(k4), alpha=dt / 6.0)

    def rk4_substep(self, w, forcing_hat, ops: ShardedOps, dt):
        """One classical RK4 substep of length dt on complex spectra."""
        return torch.view_as_complex(self._rk4_substep_v(
            torch.view_as_real(w.contiguous()), torch.view_as_real(forcing_hat.contiguous()),
            ops, dt, self._lin(ops)))

    # --------------------------------------------------------- real fields
    def _to_spectra(self, omg, forcing):
        shape = omg.shape
        n2 = shape[-2:]

        def fwd(x):
            return torch.view_as_real(dfft2(x.to(torch.float32).reshape(-1, *n2), self.mesh,
                                            mode=self.fft_mode).contiguous())

        return fwd(omg), fwd(forcing), shape

    def _to_field(self, wv, shape):
        return difft2_real(torch.view_as_complex(wv.contiguous()), self.mesh,
                           mode=self.fft_mode).reshape(shape)

    def step_real(self, omg, forcing, ops: ShardedOps, dt, oversampling: int):
        """REAL field block (..., n/S, n) -> advanced real block:
        `oversampling` RK4 substeps under a forcing held constant over the
        step (the reference's do_step, FluidSetup.jl:163-172)."""
        wv, fv, shape = self._to_spectra(omg, forcing)
        wv = self._rk4_substeps_v(wv, fv, ops, dt / oversampling, self._lin(ops), oversampling)
        return self._to_field(wv, shape)

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
        return self._to_field(wv, shape)

    def step_real_adaptive(self, omg, forcing, ops: ShardedOps, dt, rtol: float = 1.0,
                           atol: float = 1.0, max_steps: int = 256):
        """do_step2: step-doubling adaptive RK4 (FluidSetup.jl:181-186) over
        one env step. A trial of length h is taken once whole and once as
        two halves; it is accepted when max |y_two - y_full| / (atol + rtol
        |y_two|) <= 15, the maximum running over the rank's whole batch and,
        `pmax`'d, over its sp group (JAX ``ns_sharded.py:254``), so all envs
        of a dp group share the step sequence, as in the reference, and
        every rank of the sp group takes the same trials. The time and
        step-size scalars live on the host in float32, as the reference
        carries them on the device; each trial reads its error back, which
        is the loop's one synchronisation. `last_trials` keeps the count."""
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
            err = (diff.abs() / (atol + rtol * y_two.abs())).max()
            if self.mesh is not None:
                err = self.mesh.pmax(err, "sp")
            err = max(f32(err.item()), f32(1e-12))
            if err <= 15.0:  # RK4 step-doubling factor (2^4 - 1)
                wv = y_two + diff / 15.0
                t = t + h
            h = h * f32(np.clip(f32(0.9) * (f32(15.0) / err) ** f32(0.2), 0.2, 5.0))
            n += 1
        object.__setattr__(self, "last_trials", n)
        return self._to_field(wv, shape)


# the reference's complex-free twin: one class serves both here
NSShardedSolverRI = NSShardedSolver
