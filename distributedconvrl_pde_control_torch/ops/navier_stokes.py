"""2D Navier-Stokes vorticity fields: grids, Taylor vortices, initial data.

Counterpart of the host-side part of
``distributedconvrl_pde_control_tpu/ops/navier_stokes.py`` (``meshgrid_xy``,
``taylor_vortex``, ``taylorvtx_hat``, ``initial_condition``). Pure NumPy in
float64, so the same ``np.random.Generator`` gives the same fields as the
reference. The single-device ``NSSolver`` (3/2-rule padding) is not ported
yet (ROADMAP.md queue 1 item 13); the 2/3-rule solver is
``parallel/ns_sharded.py``.
"""

from __future__ import annotations

import numpy as np


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
