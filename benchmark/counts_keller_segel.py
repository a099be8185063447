"""Operation and byte counts of a Keller-Segel step, counted from shapes
alone: the work the step needs, whatever implements it (a graph of library
kernels today, a fused kernel later), so that a change to the port cannot
move the yardstick.

A right-hand side at one grid point of both fields, as the equations are
written out (`reference/keller_segel.py`): the first differences, (w[i+1] -
w[i-1]) / 2dx, 2 operations per field; the second differences, (w[i-1] -
2 w[i] + w[i+1]) / dx^2, 4 per field; u's equation u_xx + u - chi u_x v_x -
chi u v_xx - u^2, 9; v's equation v_xx - v + u + f, 3: 24 in all. A
classical RK4 substep is 4 right-hand sides, 3 stage inputs y + c k (2
operations per field) and the combination y + h/6 (k1 + 2 (k2 + k3) + k4)
(6 per field): 120 operations per grid point.
"""

from __future__ import annotations

from benchmark import counts

RHS_FLOPS_PER_POINT = 24
SUBSTEP_FLOPS_PER_POINT = 4 * RHS_FLOPS_PER_POINT + 3 * 2 * 2 + 6 * 2


def step_flops(nx: int, substeps: int, rows: int) -> float:
    """Float32 operations of one env step of `rows` envs of (2, nx)."""
    return float(SUBSTEP_FLOPS_PER_POINT * nx * substeps * rows)


def step_min_bytes(nx: int, rows: int) -> int:
    """Bytes one env step must move: the (2, nx) state and the (nx,)
    forcing read once, the state written once, float32."""
    return 4 * rows * (2 * nx + nx + 2 * nx)


def step_bound_s(nx: int, substeps: int, rows: int) -> float:
    """Least device seconds of one env step: the larger of its operations
    at the float32 peak and its bytes at the HBM rate."""
    return max(step_flops(nx, substeps, rows) / counts.PEAK_FLOPS_FP32,
               step_min_bytes(nx, rows) / counts.PEAK_BYTES_PER_S)


def train_step_flops(cell: dict) -> float:
    """Operations of one train step of `cell` (the driver's shape dict): the
    PDE step; the forcing (the actions on the actuators' top hats, scaled);
    both fields' sensor dots; the observation (the dots scaled); the reward
    (per actuator the offset from the top hat's sum, squared, scaled, its
    sign); the policy over every actuator column and `updates` DDPG updates
    at the learner batch with Adam and Polyak."""
    b, nx, n_act, n_sens = cell["rows"], cell["nx"], cell["n_actuators"], cell["n_sensors"]
    flops = step_flops(nx, cell["substeps"], b)
    flops += b * (2 * n_act * nx + nx)
    flops += b * 2 * 2 * n_sens * nx
    flops += b * 2 * n_sens
    flops += b * n_act * 4
    flops += counts.chain_flops(cell["actor"], b * n_act)
    flops += cell["updates"] * counts.ddpg_learn_flops(cell["actor"], cell["critic"], cell["batch"])
    return flops
