"""2D incompressible Navier-Stokes vorticity transport (pseudo-spectral).

Counterpart of ``distributedconvrl_pde_control_tpu/ops/navier_stokes.py``:
the single-device `NSSolver` (the reference's `src/fluid_rk4.jl`, de-aliased
by 3/2-rule zero padding) and the host-side initial data (``meshgrid_xy``,
``taylor_vortex``, ``taylorvtx_hat``, ``initial_condition``, pure NumPy in
float64, so the same ``np.random.Generator`` gives the same fields as the
reference). The 2/3-rule solver of the ``--mesh`` paths, which kernel K2
carries, is ``parallel/ns_sharded.py``.

Design. The JAX package carries spectra as (re, im) float32 pairs because
TPUs emulate complex types; here a spectrum is one complex64 tensor
(..., ny, nx) with any leading batch axes, and the ``*_ri`` methods keep the
reference's pair interface around it. One advection term is a batched
transform of the four spectra (u, v, dw/dx, dw/dy) stacked on an axis: one
gather puts the spectrum on the padded grid, one product with a
precomputed (4, nyp, nxp) table (zero in the padded band) forms the four,
one inverse 2D transform takes them to the 3/2 grid, then the product,
one forward transform, one gather back (the chop) and the 2.25 rescale. No
TPU kernel computes this term (the Pallas kernel K2 applies the 2/3 mask,
not padding). The transforms go through ``ops/fourier.py``: cuFFT at
`fft_mode="auto"`, the JAX package's DFT-product tiers otherwise, the
boundary transforms of a step at `fft_mode` and the advection's at
`nl_fft_mode` (its stacked inverse is the tier's 2D transform of the stack,
the same function as the JAX package's four).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from distributedconvrl_pde_control_torch.ops import fourier
from distributedconvrl_pde_control_torch.ops.spectral import chop_index, fft_wavenumbers, pad_index


@dataclasses.dataclass(frozen=True)
class NSSolver:
    """Wavenumber tables of one (nx, ny, Lx, Ly, nu) configuration on
    `device` (FluidSetup.jl:106-124); `dealias=True` is the reference's
    `ifpad=1` (FluidSetup.jl:101). `half_spectrum` carries the real-field
    paths (`step_real`, `step_real_if`) on the Hermitian half (kx >= 0).
    `fft_mode` is the transform tier of the boundary transforms and of the
    complex-spectra paths' advection, `nl_fft_mode` (None: `fft_mode`) that
    of the real-field paths' advection (its error enters scaled by dt)."""

    nx: int
    ny: int
    lx: float = 1.0
    ly: float = 1.0
    nu: float = 5e-5
    dealias: bool = True
    fft_mode: str = "auto"
    nl_fft_mode: str | None = None
    half_spectrum: bool = False
    device: str = "cuda"

    kx_row: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    ky_col: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    k2: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    inv_k2: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        fourier.use_matmul_dft(self.fft_mode)  # an unknown mode raises here
        fourier.use_matmul_dft(self.nl_mode)
        kx = fft_wavenumbers(self.nx, self.lx)
        ky = fft_wavenumbers(self.ny, self.ly)
        # kx varies along columns (axis 1), ky along rows (axis 0), as
        # kx_repeat / ky_repeat at FluidSetup.jl:117-118
        kx_row = np.broadcast_to(kx[None, :], (self.ny, self.nx))
        ky_col = np.broadcast_to(ky[:, None], (self.ny, self.nx))
        k2 = ky_col**2 + kx_row**2  # FluidSetup.jl:116
        inv_k2 = 1.0 / np.where(k2 == 0.0, 1.0, k2)
        inv_k2[0, 0] = 0.0  # psihat[1,1] = 0 (fluid_rk4.jl:153)
        for name, a in (("kx_row", kx_row), ("ky_col", ky_col), ("k2", k2), ("inv_k2", inv_k2)):
            object.__setattr__(self, name, torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                                           device=self.device))

    # ---------------------------------------------------------- operators
    @property
    def nl_mode(self) -> str:
        return self.nl_fft_mode or self.fft_mode

    @property
    def _nxh(self) -> int:
        return self.nx // 2 + 1

    @property
    def padded_shape(self) -> tuple:
        return (3 * self.ny // 2, 3 * self.nx // 2) if self.dealias else (self.ny, self.nx)

    @functools.cached_property
    def _tables(self):
        """Per spectrum layout (False: full, True: half): the (4, ...)
        complex table of the spectra u = i ky psi, v = -i kx psi, dw/dx =
        i kx w, dw/dy = i ky w with psi = w / k^2, on the padded grid
        (flattened, zero in the padded band) when de-aliasing, with the
        gather that puts a spectrum on that grid."""
        out = {}
        for half in (False, True):
            cols = slice(0, self._nxh) if half else slice(None)
            kx, ky, inv = (t[:, cols] for t in (self.kx_row, self.ky_col, self.inv_k2))
            z = torch.zeros_like(kx)
            table = torch.stack([torch.complex(z, ky * inv), torch.complex(z, -kx * inv),
                                 torch.complex(z, kx), torch.complex(z, ky)])
            if self.dealias:
                nyp, nxp = self.padded_shape
                ncols = nxp // 2 + 1 if half else nxp
                idx, keep = pad_index(self.ny, table.shape[-1], nyp, ncols, half, self.device)
                table = torch.where(keep, table.flatten(-2).index_select(-1, idx), 0.0)
                out[half] = (table, idx)
            else:
                out[half] = (table, None)
        return out

    def _stage_spectra(self, w: torch.Tensor, half: bool) -> torch.Tensor:
        """(..., 4, nyp, nxp) spectra (u, v, dw/dx, dw/dy) of w on the
        transform grid."""
        table, idx = self._tables[half]
        if idx is None:
            return w.unsqueeze(-3) * table
        nyp, nxp = self.padded_shape
        g = w.flatten(-2).index_select(-1, idx).unsqueeze(-2) * table
        return g.unflatten(-1, (nyp, nxp // 2 + 1 if half else nxp))

    def _advection_c(self, w: torch.Tensor, half: bool, mode: str) -> torch.Tensor:
        """Advection term -u dw/dx - v dw/dy in wavespace (fluid_rk4.jl:
        145-190) of complex spectra (..., ny, nx) (half: (..., ny, nx//2+1)),
        its transforms at `mode`."""
        spectra = self._stage_spectra(w, half)
        nyp, nxp = self.padded_shape
        if half:
            r = fourier.irfft2(spectra, nxp, mode=mode)
        else:
            r = fourier.ifft2(spectra, mode=mode).real
        u, v, dwdx, dwdy = r.unbind(-3)
        prod = -u * dwdx - v * dwdy
        t = fourier.rfft2(prod, mode=mode) if half else fourier.fft2(prod, mode=mode)
        if not self.dealias:
            return t
        idx = chop_index(self.ny, self._nxh if half else self.nx, nyp,
                         nxp // 2 + 1 if half else nxp, half, t.device)
        # * 1.5 * 1.5 rescales the padded grid's transform normalization
        # (fluid_rk4.jl:176)
        return t.flatten(-2).index_select(-1, idx).unflatten(-1, w.shape[-2:]) * 2.25

    # ----------------------------------------------------- complex spectra
    def advection(self, omghat: torch.Tensor) -> torch.Tensor:
        """Nonlinear advection term in wavespace (fluid_rk4.jl:145-190)."""
        return self._advection_c(omghat, False, self.fft_mode)

    def rhs(self, omghat: torch.Tensor, forcing_hat: torch.Tensor) -> torch.Tensor:
        """d(omega_hat)/dt = -nu k^2 omega_hat + advection + forcing
        (fluid_rk4.jl:134-143)."""
        return -self.nu * (self.k2 * omghat) + self.advection(omghat) + forcing_hat

    def rk4_substep(self, omghat, forcing_hat, dt):
        """Classic RK4 (fluid_rk4.jl:122-132)."""
        return _rk4(lambda w: self.rhs(w, forcing_hat), omghat, dt)

    def step(self, omghat, forcing_hat, dt, oversampling: int):
        """One env step = `oversampling` RK4 substeps at dt/oversampling,
        the reference's fixed-step `do_step` (FluidSetup.jl:163-172)."""
        dt_os = dt / oversampling
        w = omghat
        for _ in range(oversampling):
            w = self.rk4_substep(w, forcing_hat, dt_os)
        return w

    # Integrating-factor RK4, an extension of the JAX package (its reference
    # steps plain RK4): the viscous term is integrated exactly by the
    # elementwise factors exp(-nu k^2 t), RK4 acts on advection + forcing.
    def _ifrk4(self, w, n_of, dt, k2):
        e_half = torch.exp(-self.nu * k2 * (dt / 2.0))
        e_full = e_half * e_half
        k1 = n_of(w)
        k2_ = n_of(e_half * (w + 0.5 * dt * k1))
        k3 = n_of(e_half * w + 0.5 * dt * k2_)
        k4 = n_of(e_full * w + dt * e_half * k3)
        return e_full * w + dt / 6.0 * (e_full * k1 + 2.0 * e_half * (k2_ + k3) + k4)

    def ifrk4_substep(self, omghat, forcing_hat, dt):
        return self._ifrk4(omghat, lambda w: self.advection(w) + forcing_hat, dt, self.k2)

    def step_if(self, omghat, forcing_hat, dt, oversampling: int):
        """One env step = `oversampling` IF-RK4 substeps (complex spectra)."""
        dt_os = dt / oversampling
        w = omghat
        for _ in range(oversampling):
            w = self.ifrk4_substep(w, forcing_hat, dt_os)
        return w

    # ------------------------------------------------------- real fields
    @property
    def _k2h(self) -> torch.Tensor:
        return self.k2[:, : self._nxh] if self.half_spectrum else self.k2

    def forward_real(self, x: torch.Tensor) -> torch.Tensor:
        """Spectrum of a real field in the layout of the real-field paths."""
        x = x.to(torch.float32)
        if self.half_spectrum:
            return fourier.rfft2(x, mode=self.fft_mode)
        return fourier.fft2(x, mode=self.fft_mode)

    def inverse_real(self, w: torch.Tensor) -> torch.Tensor:
        """Real field of a spectrum in the layout of the real-field paths."""
        if self.half_spectrum:
            return fourier.irfft2(w, self.nx, mode=self.fft_mode)
        return fourier.ifft2(w, mode=self.fft_mode).real

    def rhs_real_layout(self, w: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """-nu k^2 w + advection(w) + f in the real-field paths' layout."""
        return (-self.nu * self._k2h * w
                + self._advection_c(w, self.half_spectrum, self.nl_mode) + f)

    def _advection_ri(self, wr, wi):
        """Advection of (re, im) spectra (full or half), as a pair."""
        a = self._advection_c(torch.complex(wr, wi), self.half_spectrum, self.nl_mode)
        return a.real, a.imag

    def _rhs_ri(self, wr, wi, fr, fi):
        r = self.rhs_real_layout(torch.complex(wr, wi), torch.complex(fr, fi))
        return r.real, r.imag

    def step_real(self, omg: torch.Tensor, forcing: torch.Tensor, dt, oversampling: int):
        """One env step on REAL vorticity fields (..., ny, nx) with real
        forcing: `step`'s scheme (RK4 x oversampling, fluid_rk4.jl:122-132)
        between one forward and one inverse transform."""
        dt_os = dt / oversampling
        w, f = self.forward_real(omg), self.forward_real(forcing)
        for _ in range(oversampling):
            w = _rk4(lambda z: self.rhs_real_layout(z, f), w, dt_os)
        return self.inverse_real(w)

    def step_real_if(self, omg: torch.Tensor, forcing: torch.Tensor, dt, oversampling: int):
        """One env step on REAL vorticity fields by IF-RK4 (`ifrk4_substep`)."""
        dt_os = dt / oversampling
        w, f = self.forward_real(omg), self.forward_real(forcing)

        def n_of(z):
            return self._advection_c(z, self.half_spectrum, self.nl_mode) + f

        for _ in range(oversampling):
            w = self._ifrk4(w, n_of, dt_os, self._k2h)
        return self.inverse_real(w)

    # ------------------------------------------------------------ diagnostics
    def omg2vel(self, omghat):
        """(u, v, omega, psi) in real space from spectral vorticity
        (fluid_rk4.jl:20-52)."""
        psihat = omghat * self.inv_k2
        uhat = 1j * self.ky_col * psihat
        vhat = -1j * self.kx_row * psihat
        spectra = torch.stack([uhat, vhat, omghat, psihat], dim=-3)
        u, v, omg, psi = fourier.ifft2(spectra, mode=self.fft_mode).real.unbind(-3)
        return u, v, omg, psi


def _rk4(f, y, dt):
    """y + dt/6 (k1 + 2 (k2 + k3) + k4) of classic RK4."""
    k1 = f(y)
    k2 = f(y + 0.5 * dt * k1)
    k3 = f(y + 0.5 * dt * k2)
    k4 = f(y + dt * k3)
    return y + dt / 6.0 * (k1 + 2.0 * (k2 + k3) + k4)


# --------------------------------------------------------------- initial data
def meshgrid_xy(nx, ny, lx, ly):
    """Collocation grid (xx[r,c] = x[c], yy[r,c] = y[r]), matching
    fluid_rk4.jl:10-15 + FluidSetup.jl:127-133 (endpoint dropped)."""
    x = np.linspace(0.0, lx, nx + 1)[:nx]
    y = np.linspace(0.0, ly, ny + 1)[:ny]
    xx = np.broadcast_to(x[None, :], (ny, nx))
    yy = np.broadcast_to(y[:, None], (ny, nx))
    return xx, yy


def taylor_vortex(xx, yy, x0, y0, a0, u_max, lx, ly):
    """Taylor-vortex vorticity bump with 3x3 periodic images, in real space
    (fluid_rk4.jl:54-69 computes the same then ffts it)."""
    omg = np.zeros_like(xx)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            r2 = (xx - x0 - i * lx) ** 2 + (yy - y0 - j * ly) ** 2
            omg = omg + u_max / a0 * (2.0 - r2 / a0**2) * np.exp(0.5 * (1.0 - r2 / a0**2))
    return omg


def taylorvtx_hat(xx, yy, x0, y0, a0, u_max, lx, ly):
    """Spectral Taylor vortex, matching fluid_rk4.jl:54-69."""
    return np.fft.fft2(taylor_vortex(xx, yy, x0, y0, a0, u_max, lx, ly))


def initial_condition(caseno: int, nx, ny, lx, ly, rng: np.random.Generator):
    """Initial spectral vorticity fields, cases 1-4 of fluid_rk4.jl:72-120.

    1: one Taylor vortex; 2: two co-rotating; 3: 30 random vortices;
    4: 50 random vortices with randomized radii.
    """
    xx, yy = meshgrid_xy(nx, ny, lx, ly)
    if caseno == 1:
        return taylorvtx_hat(xx, yy, lx / 2, ly / 2, lx / 8, 1.0, lx, ly)
    if caseno == 2:
        w = taylorvtx_hat(xx, yy, lx / 2, 0.4 * ly, lx / 10.0, 1.0, lx, ly)
        return w + taylorvtx_hat(xx, yy, lx / 2, 0.6 * ly, lx / 10.0, 1.0, lx, ly)
    if caseno in (3, 4):
        nv = 30 if caseno == 3 else 50
        omg = np.zeros((ny, nx))
        for _ in range(nv):
            x0 = rng.uniform(0, lx)
            y0 = rng.uniform(0, ly)
            a0 = lx / 20.0 if caseno == 3 else lx / 20.0 * (0.5 + rng.uniform())
            umax = rng.uniform(-1.0, 1.0)
            omg = omg + taylor_vortex(xx, yy, x0, y0, a0, umax, lx, ly)
        return np.fft.fft2(omg)
    raise ValueError(f"unknown IC case {caseno}")
