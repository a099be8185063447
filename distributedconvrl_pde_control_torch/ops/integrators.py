"""Fixed-step and adaptive integrators for user-supplied right-hand sides.

Counterpart of ``distributedconvrl_pde_control_tpu/ops/integrators.py``,
the stand-ins for the reference's generic steppers (`src/PDEenv.jl:201-218`):

  * `midpoint_oversampled` - the reference's default two-stage scheme
    (PDEenv.jl:208-214): y <- y_old + dt*f(y_old + dt/2 * f(y_old));
  * `rk4_oversampled`      - classic RK4, fixed substeps;
  * `rk4_adaptive`         - step-doubling adaptive RK4 over one env step
    (the reference's adaptive RK4 at FluidSetup.jl:181-186);
  * `implicit_trapezoid`   - Newton-iterated Crank-Nicolson, the fixed-cost
    replacement of the reference's RadauIIA5 (PDEenv.jl:203-206).

Each takes `f(y, forcing) -> dy/dt`, time-autonomous within an env step. The
state `y` (real or complex) carries the env batch on its leading axis, and
every env is integrated as if it ran alone, which is what the JAX functions
give under `vmap`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def midpoint_oversampled(f, y, forcing, dt, oversampling: int):
    """Reference default stepper, PDEenv.jl:208-214 (midpoint RK2)."""
    dt_os = dt / oversampling
    for _ in range(oversampling):
        y_mid = y + 0.5 * dt_os * f(y, forcing)
        y = y + dt_os * f(y_mid, forcing)
    return y


def _rk4_step(f, y, forcing, dt):
    """One classic RK4 step; `dt` a number or a tensor that broadcasts
    against y (one step length per env)."""
    k1 = f(y, forcing)
    k2 = f(y + 0.5 * dt * k1, forcing)
    k3 = f(y + 0.5 * dt * k2, forcing)
    k4 = f(y + dt * k3, forcing)
    return y + dt / 6.0 * (k1 + 2.0 * (k2 + k3) + k4)


def rk4_oversampled(f, y, forcing, dt, oversampling: int):
    dt_os = dt / oversampling
    for _ in range(oversampling):
        y = _rk4_step(f, y, forcing, dt_os)
    return y


def rk4_adaptive(f, y, forcing, dt, rtol=1e-8, atol=1e-8, max_steps: int = 4096,
                 info: Optional[dict] = None):
    """Step-doubling adaptive RK4 over one env step of length `dt`, with
    its own step control for each env of the batch (axis 0 of y).

    A trial of length h takes one full step and two half steps; its error
    is max |y_two - y_full| / (atol + rtol |y_two|) over the env's
    components (a complex state counts its real and imaginary parts apart,
    as the JAX package's (re, im) pairs do). The env accepts the trial when
    the error is <= 15 (2^4 - 1) and takes y_two + (y_two - y_full) / 15;
    either way h <- h clip(0.9 (15 / err)^0.2, 0.2, 5), after h <- min(h, dt
    - t). An env runs until its t reaches dt or it has made `max_steps`
    trials, and stays frozen while the others go on. t, h and the trial
    counts are float32 / integer numbers on the host, as JAX carries them in
    float32; each trial reads its (B,) errors back, which is the loop's one
    synchronisation. `info`, when given, receives the per-env trial counts
    under "trials".
    """
    f32 = np.float32
    b = y.shape[0]
    t = np.zeros(b, f32)
    h = np.full(b, f32(dt / 16.0), f32)
    n = np.zeros(b, np.int64)
    t_end, t_stop = f32(dt), f32(dt * (1 - 1e-12))
    bshape = (b,) + (1,) * (y.dim() - 1)
    rdt = torch.float32
    while True:
        active = (t < t_stop) & (n < max_steps)
        if not active.any():
            break
        hs = np.where(active, np.minimum(h, t_end - t), f32(0.0)).astype(f32)
        ctl = torch.from_numpy(np.stack([hs, active.astype(f32)])).to(y.device)
        hd, act = ctl[0].reshape(bshape), ctl[1] > 0
        y_full = _rk4_step(f, y, forcing, hd)
        y_half = _rk4_step(f, y, forcing, hd / 2.0)
        y_two = _rk4_step(f, y_half, forcing, hd / 2.0)
        diff = y_two - y_full
        dr, yr = (torch.view_as_real(diff), torch.view_as_real(y_two)) if y.is_complex() else (
            diff, y_two)
        err = (dr.abs() / (atol + rtol * yr.abs())).reshape(b, -1).amax(dim=1).to(rdt)
        err = torch.clamp(err, min=1e-12)
        accept = act & (err <= 15.0)
        y = torch.where(accept.reshape(bshape), y_two + diff / 15.0, y)
        err_h = err.cpu().numpy()  # the trial's one device-to-host read
        acc_h = active & (err_h <= f32(15.0))
        t = np.where(acc_h, t + hs, t).astype(f32)
        grow = np.clip(f32(0.9) * (f32(15.0) / err_h) ** f32(0.2), f32(0.2), f32(5.0))
        h = np.where(active, hs * grow, h).astype(f32)
        n = n + active
    if info is not None:
        info["trials"] = n
    return y


def implicit_trapezoid(f, y, forcing, dt, oversampling: int, n_iters: int = 4):
    """Newton-iterated Crank-Nicolson: solve y1 = y0 + dt/2 (f(y0) + f(y1)).

    A-stable, second order. Each env's Jacobian comes from
    `torch.func.jacfwd` on its flattened state and each Newton step is a
    dense `torch.linalg.solve`, so this targets small 1D systems, the
    reference's RadauIIA5 domain. `forcing` is None or batched like y.
    """
    dt_os = dt / oversampling
    out = []
    for i in range(y.shape[0]):
        shape = y.shape[1:]
        fi = None if forcing is None else forcing[i: i + 1]

        def f_flat(yf, fi=fi, shape=shape):
            return f(yf.reshape((1,) + tuple(shape)), fi).reshape(-1)

        yf = y[i].reshape(-1)
        eye = torch.eye(yf.numel(), dtype=y.dtype, device=y.device)
        for _ in range(oversampling):
            f0 = f_flat(yf)
            y1 = yf + dt_os * f0
            for _ in range(n_iters):
                r = y1 - yf - 0.5 * dt_os * (f0 + f_flat(y1))
                jac = eye - 0.5 * dt_os * torch.func.jacfwd(f_flat)(y1)
                y1 = y1 - torch.linalg.solve(jac, r)
            yf = y1
        out.append(yf.reshape(shape))
    return torch.stack(out)
