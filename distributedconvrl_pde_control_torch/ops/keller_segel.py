"""Keller-Segel chemotaxis: two coupled fields (u = cell density, v =
chemo-attractant) on a 1D grid, finite-difference right-hand side, RK4.

Counterpart of ``distributedconvrl_pde_control_tpu/ops/keller_segel.py``,
the re-derivation of `scripts/Keller-Segel/setup/KellerSegelSetup.jl:213-239`:

    v_t = v_xx - v + u + forcing
    u_t = u_xx + u - 5.6 * u_x * v_x - 5.6 * u * v_xx - u^2

with central differences on a periodic roll clamped at the two ends (the
reference overwrites the wrapped ghost values with the boundary values,
KellerSegelSetup.jl:221-224), and fixed-step RK4 with `oversampling`
substeps as in the JAX package. States are (B, 2, nx), forcings (B, nx).

Design. At nx = 100 a right-hand side is ~20 elementwise launches of a few
hundred points each, so an env step of 10 substeps is ~800 launches whose
device work is a few microseconds apiece: the host's launch rate would set
the pace. Nothing in the step reads the device, so on the card
`KellerSegelSolver.step` is one captured CUDA graph per (device, batch
shape, dt, oversampling): the inputs are copied into the graph's static
buffers, the graph is replayed, and a copy of its output is returned. A
capture that fails raises; nothing falls back to eager launches on the
card. On the CPU the same arithmetic runs eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _clamped_shifts(w: torch.Tensor):
    """(w[i-1], w[i+1]) along the last axis with the boundary clamping of
    KellerSegelSetup.jl:221-224."""
    wm = torch.cat([w[..., :1], w[..., :-1]], dim=-1)
    wp = torch.cat([w[..., 1:], w[..., -1:]], dim=-1)
    return wm, wp


class _CapturedStep:
    """One CUDA graph of `fn(y, forcing)` at fixed shapes, with its static
    input and output buffers."""

    def __init__(self, fn, y: torch.Tensor, forcing: torch.Tensor):
        self.y, self.forcing = y.clone(), forcing.clone()
        side = torch.cuda.Stream(device=y.device)
        side.wait_stream(torch.cuda.current_stream(y.device))
        with torch.cuda.stream(side):  # warm-up outside the capture, as torch.cuda.graph asks
            for _ in range(2):
                fn(self.y, self.forcing)
        torch.cuda.current_stream(y.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread-local: a process group's watchdog thread may query its events
        # while this thread captures (the sharded trainer at sp = 1)
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = fn(self.y, self.forcing)

    def __call__(self, y: torch.Tensor, forcing: torch.Tensor) -> torch.Tensor:
        self.y.copy_(y)
        self.forcing.copy_(forcing)
        self.graph.replay()
        return self.out.clone()


@dataclasses.dataclass(frozen=True)
class KellerSegelSolver:
    """FD Keller-Segel solver of one (nx, Lx) configuration."""

    nx: int
    lx: float
    chi: float = 5.6  # chemotactic sensitivity (the literal 5.6 of :228-229)
    graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    def rhs(self, y: torch.Tensor, forcing: torch.Tensor) -> torch.Tensor:
        """dy/dt of y (B, 2, nx), rows (u, v) (KellerSegelSetup.jl:213-232)."""
        u, v = y[:, 0], y[:, 1]
        dx = self.dx
        ym, yp = _clamped_shifts(y)
        d1 = (yp - ym) / (2.0 * dx)
        d2 = (ym - 2.0 * y + yp) / (dx * dx)
        du1, dv1 = d1[:, 0], d1[:, 1]
        du2, dv2 = d2[:, 0], d2[:, 1]
        dv = dv2 - v + u + forcing
        du = du2 + u - self.chi * du1 * dv1 - self.chi * u * dv2 - u * u
        return torch.stack([du, dv], dim=1)

    def step_eager(self, y, forcing, dt, oversampling: int):
        """One env step = `oversampling` classic-RK4 substeps, launched op by op."""
        dt_os = dt / oversampling
        for _ in range(oversampling):
            k1 = self.rhs(y, forcing)
            k2 = self.rhs(y + 0.5 * dt_os * k1, forcing)
            k3 = self.rhs(y + 0.5 * dt_os * k2, forcing)
            k4 = self.rhs(y + dt_os * k3, forcing)
            y = y + dt_os / 6.0 * (k1 + 2.0 * (k2 + k3) + k4)
        return y

    @torch.no_grad()
    def step(self, y, forcing, dt, oversampling: int):
        """One env step: a replay of the step's CUDA graph on a CUDA tensor
        (captured at the first call of its shape), `step_eager` on a CPU one."""
        if not y.is_cuda:
            return self.step_eager(y, forcing, dt, oversampling)
        y, forcing = y.to(torch.float32).contiguous(), forcing.to(torch.float32).contiguous()
        key = (str(y.device), tuple(y.shape), tuple(forcing.shape), float(dt), int(oversampling))
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = _CapturedStep(
                lambda a, b: self.step_eager(a, b, dt, oversampling), y, forcing)
        return graph(y, forcing)


@dataclasses.dataclass(frozen=True)
class KellerSegelSpectralLegacy:
    """The reference's `do_step_wrong` (KellerSegelSetup.jl:143-211), kept
    for cross-checking as the JAX package keeps it: semi-implicit CNAB2 on
    both fields with the linear operators Lu = 1 - k^2 and Lv = 1 + k^2 as
    the reference writes them, and the boundary zeroing of derivative
    endpoints. The reference's authors mark it wrong (the spectral treatment
    of the clamped boundary is inconsistent); `KellerSegelSolver` is the
    physics."""

    nx: int
    lx: float
    chi: float = 5.6
    fft_mode: str = "auto"

    def step(self, y, forcing, dt, oversampling: int):
        from distributedconvrl_pde_control_torch.ops import fourier

        mode, nx, dev = self.fft_mode, self.nx, y.device
        k = np.concatenate([np.arange(0, nx // 2), [0], np.arange(-nx // 2 + 1, 0)])
        alpha = (2 * np.pi * k / self.lx).astype(np.float32)
        alpha_r = np.abs(alpha[: nx // 2 + 1]).astype(np.float32)
        alpha_r[-1] = 0.0
        lu = 1.0 - alpha_r**2
        lv = 1.0 + alpha_r**2
        dt_os = dt / oversampling
        dt2, dt32 = dt_os / 2, 3 * dt_os / 2

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        au_inv, av_inv = t32(1.0 / (1.0 - dt2 * lu)), t32(1.0 / (1.0 - dt2 * lv))
        bu, bv = t32(1.0 + dt2 * lu), t32(1.0 + dt2 * lv)
        ka = t32(alpha_r)
        d1 = torch.complex(torch.zeros_like(ka), ka)  # i alpha
        d2 = -(ka**2)  # -alpha^2

        def nonlin_u(uh, vh):
            u_real = fourier.irfft(uh, nx, mode=mode)
            u1 = fourier.irfft(d1 * uh, nx, mode=mode)
            v1 = fourier.irfft(d1 * vh, nx, mode=mode)
            u1[..., 0] = 0.0
            v1[..., -1] = 0.0
            v2 = fourier.irfft(d2 * vh, nx, mode=mode)
            return fourier.rfft(self.chi * u1 * v1 - self.chi * u_real * v2 - u_real * u_real,
                                mode=mode)

        uh = fourier.rfft(y[:, 0], mode=mode)
        vh = fourier.rfft(y[:, 1], mode=mode)
        nu_, nv_ = nonlin_u(uh, vh), uh  # Nn_v = u (KellerSegelSetup.jl:175)
        fh = fourier.rfft(forcing, mode=mode)
        for _ in range(oversampling):
            n1u, n1v = nu_, nv_
            nu_, nv_ = nonlin_u(uh, vh), uh
            uh = au_inv * (bu * uh + dt32 * nu_ - dt2 * n1u)
            vh = av_inv * (bv * vh + dt32 * nv_ - dt2 * n1v + dt_os * fh)
        return torch.stack([fourier.irfft(uh, nx, mode=mode), fourier.irfft(vh, nx, mode=mode)],
                           dim=1)
