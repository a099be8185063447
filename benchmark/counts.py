"""Operation and byte counts of the benchmark, counted from shapes alone.

`ks_flops_per_row`, `ns_flops` and `ns_min_bytes` are frozen copies of the
port's `ops/kernels/ks_kernel.py::flops_per_row` and
`ops/kernels/ns_advection.py::flops` / `min_bytes`: the work a KS env step
and one masked advection evaluation need, whatever implements them. A later
change to the port cannot move the yardstick; a CPU test holds the copies
equal to the port's at the cells' shapes. The rest counts the whole train or
control step for `mfu.*`: the PDE step, the shared policy over every
actuator column, the DDPG update at the learner batch, Adam and Polyak, the
sensor readout and the action smearing.
"""

from __future__ import annotations

import numpy as np

# NVIDIA's data sheet for one H100 SXM: float32 outside the tensor cores, HBM3.
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES_PER_S = 3.35e12


def ks_flops_per_row(nx: int, oversampling: int) -> float:
    """Float32 operations one KS env step needs per env row (CNAB2,
    `oversampling` substeps): 2*oversampling+2 real FFTs of length nx at
    2.5*nx*log2(nx) flops, ~14 flops per bin and substep for the update, 1
    per point and substep for the square."""
    nf = nx // 2 + 1
    fft = 2.5 * nx * np.log2(nx)
    return (2 * oversampling + 2) * fft + oversampling * (14 * nf + nx)


def ns_flops(n: int, batch: int) -> float:
    """Float32 operations of one masked advection evaluation of `batch`
    (n, n) spectra: 2.5 complex 2D FFTs at 5*N*log2(N) flops for N = n*n,
    plus ~30 flops per point."""
    points = n * n
    return batch * (2.5 * 5.0 * points * np.log2(points) + 30.0 * points)


def ns_min_bytes(n: int, batch: int) -> int:
    """Bytes one advection evaluation must move: the complex64 spectrum read
    once and written once."""
    return 16 * batch * n * n


def ks_step_bound_s(nx: int, oversampling: int, rows: int) -> float:
    """Least device seconds of one KS env step over `rows` rows: its
    operations at the float32 peak (the step is bound by operations)."""
    return ks_flops_per_row(nx, oversampling) * rows / PEAK_FLOPS_FP32


def ns_step_bound_s(n: int, batch: int, substeps: int) -> float:
    """Least device seconds of one fluid env step: 4 advection evaluations
    per RK4 substep, each the larger of its operations at the float32 peak
    and its bytes at the HBM rate."""
    per_eval = max(ns_flops(n, batch) / PEAK_FLOPS_FP32, ns_min_bytes(n, batch) / PEAK_BYTES_PER_S)
    return 4 * substeps * per_eval


# ------------------------------------------------------------- networks
def chain_flops(sizes: list[int], cols: int) -> float:
    """Forward operations of a dense chain over `cols` columns: a multiply
    and an add per weight, an add per bias, one operation per activation."""
    return cols * sum(2 * a * b + 2 * b for a, b in zip(sizes[:-1], sizes[1:]))


def chain_params(sizes: list[int]) -> int:
    return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


def ddpg_learn_flops(actor: list[int], critic: list[int], batch: int) -> float:
    """One DDPG update at `batch`: the target actor and critic forward, the
    critic forward and backward (weights and inputs: twice the forward), the
    actor forward, the updated critic's forward and its input gradients
    (once more), the actor's backward (twice its forward), Adam on both
    networks (~12 operations per parameter) and Polyak on both targets (3)."""
    fa, fc = chain_flops(actor, batch), chain_flops(critic, batch)
    params = chain_params(actor) + chain_params(critic)
    return (fa + fc) + (fc + 2 * fc) + (fa + fc + fc + 2 * fa) + 12 * params + 3 * params


def ks_step_flops(cell: dict) -> float:
    """Operations of one KS step of `cell` (the driver's shape dict): the
    PDE step, the smearing of 8 actions onto the grid, the sensor and reward
    dot products, the policy over every actuator column and, when training,
    `updates` DDPG updates."""
    b, nx, n_act = cell["rows"], cell["nx"], cell["n_actuators"]
    flops = ks_flops_per_row(nx, cell["oversampling"]) * b
    flops += 3 * 2 * b * n_act * nx  # forcing, sensor dots, reward dots
    flops += chain_flops(cell["actor"], b * n_act)
    flops += cell.get("updates", 0) * ddpg_learn_flops(cell["actor"], cell["critic"],
                                                       cell.get("batch", 0))
    return flops


def fluid_step_flops(cell: dict) -> float:
    """Operations of one fluid train step: 4 advection evaluations per RK4
    substep, the boundary transforms (forward of the field and the forcing,
    the inverse of the result: 3 complex 2D FFTs), the smearing of every
    actuator's action onto the grid and the sensor readout (each 2*n_act*n^2
    per env), the policy over every actuator column and the DDPG updates."""
    b, n, n_act = cell["rows"], cell["n"], cell["n_actuators"]
    points = n * n
    flops = 4 * cell["substeps"] * ns_flops(n, b)
    flops += 3 * b * 5.0 * points * np.log2(points)
    flops += 2 * 2 * b * n_act * points
    flops += chain_flops(cell["actor"], b * n_act)
    flops += cell.get("updates", 0) * ddpg_learn_flops(cell["actor"], cell["critic"],
                                                       cell.get("batch", 0))
    return flops
