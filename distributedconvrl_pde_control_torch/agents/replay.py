"""Per-actuator replay buffer on the trainer's device.

Counterpart of ``distributedconvrl_pde_control_tpu/agents/replay.py``. The
reference interleaves every actuator's (s, a, r, t) as independent rows of
one `CircularArraySARTTrajectory` and resolves the next state as the entry
`n_actuators` slots ahead (src/PDEagent.jl:254-340). Here, as in the JAX
package, the next state is stored explicitly (SARTS'), which is the same
effective transition set:
  * the state pushed at PreAct of step k+1 equals the featurized state after
    step k, exactly what `state[idx + n_actuators]` dereferences;
  * terminal rows mask the bootstrap identically;
  * the reference samples logical indices 1..len-n_actuators, i.e. it
    excludes the newest `n_actuators` rows: kept via `exclude_newest`.

Layout. One float32 matrix `buf` of shape (capacity, ns + na + 2 + ns):
a transition is one contiguous row [s | a | r | t | sn]. On a GPU every
operation is a kernel launch and the batched trainer is bound by the host's
launch rate, so the layout is the one with the fewest launches: a push
writes one block of rows (contiguous in memory when the capacity divides by
the push width), a sample is one row gather of `batch_size` short contiguous
rows, and the column matrices the learner consumes ((dim, batch), actuator =
column) are transposed views of the gathered block, which a matrix product
reads without a copy. `ptr` and `size` are functions of the number of pushes
alone (the push width is static), so they are host integers and no push or
sample reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from distributedconvrl_pde_control_torch.utils.profiling import annotate


@dataclasses.dataclass
class Replay:
    buf: torch.Tensor  # (capacity, 2*ns + na + 2) float32 rows [s | a | r | t | sn]
    ns: int
    na: int
    ptr: int = 0  # next write slot
    size: int = 0  # valid entries

    @property
    def capacity(self) -> int:
        return self.buf.shape[0]

    # column views in the JAX package's (dim, capacity) orientation
    @property
    def s(self) -> torch.Tensor:
        return self.buf[:, :self.ns].T

    @property
    def a(self) -> torch.Tensor:
        return self.buf[:, self.ns:self.ns + self.na].T

    @property
    def r(self) -> torch.Tensor:
        return self.buf[:, self.ns + self.na]

    @property
    def t(self) -> torch.Tensor:
        return self.buf[:, self.ns + self.na + 1]

    @property
    def sn(self) -> torch.Tensor:
        return self.buf[:, self.ns + self.na + 2:].T


def replay_init(capacity: int, ns: int, na: int, device="cuda") -> Replay:
    return Replay(buf=torch.zeros((capacity, 2 * ns + na + 2), dtype=torch.float32, device=device),
                  ns=ns, na=na)


def _split_rows(rows: torch.Tensor, ns: int, na: int):
    """(n, width) transition rows -> (s, a, r, t, sn) with s, a, sn as
    (dim, n) column views."""
    return (rows[:, :ns].T, rows[:, ns:ns + na].T, rows[:, ns + na], rows[:, ns + na + 1],
            rows[:, ns + na + 2:].T)


def replay_push_flat(rb: Replay, s_cols, a_cols, r_vec, t_vec, sn_cols) -> Replay:
    """Push `n` transitions given as column blocks (dim, n), in place.

    When the capacity divides evenly by the push width (true for every
    shipped preset and for the batched trainer, which rounds its capacity
    up), the pointer only ever visits multiples of n, so blocks never wrap
    and the write is one concatenation straight into a contiguous slice of
    the buffer. The scatter through wrapped indices serves other widths.
    """
    n = r_vec.shape[0]
    capacity = rb.capacity
    parts = [s_cols.T, a_cols.T, r_vec[:, None], t_vec[:, None], sn_cols.T]
    if capacity % n == 0:
        torch.cat(parts, dim=1, out=rb.buf[rb.ptr:rb.ptr + n])
    else:
        idx = (rb.ptr + torch.arange(n, device=rb.buf.device)) % capacity
        rb.buf.index_copy_(0, idx, torch.cat(parts, dim=1))
    rb.ptr = (rb.ptr + n) % capacity
    rb.size = min(rb.size + n, capacity)
    return rb


def replay_push_columns(rb: Replay, s_cols, a_cols, r_vec, terminal: bool, sn_cols) -> Replay:
    """Push one env step's per-actuator transitions.

    s_cols/a_cols/sn_cols: (dim, n_cols) column matrices (actuator = column,
    as in the PreAct/PostAct pushes at PDEagent.jl:254-289); r_vec: (n_cols,)
    or (1,) in mono mode; terminal: one flag shared by all columns.
    """
    t_vec = torch.full_like(r_vec, float(terminal))
    return replay_push_flat(rb, s_cols, a_cols, r_vec, t_vec, sn_cols)


@annotate("replay.sample")
def replay_sample(rb: Replay, batch_size: int, exclude_newest: int,
                  generator: Optional[torch.Generator] = None,
                  offs: Optional[torch.Tensor] = None):
    """Uniform sample of `batch_size` transitions as column matrices
    (s, a, r, t, sn).

    Logical index o in [0, size - exclude_newest) maps to physical slot
    (start + o) % capacity where start is the oldest entry: the same
    distribution as `pde_sample`'s `rand(1:length(t)-number_actuators)`
    (PDEagent.jl:317-321). `offs` (batch_size,) replaces the draw, which is
    otherwise made from `generator` on the buffer's device.
    """
    if offs is None:
        n_valid = max(rb.size - exclude_newest, 1)
        offs = torch.randint(0, n_valid, (batch_size,), generator=generator,
                             device=rb.buf.device)
    start = rb.ptr if rb.size >= rb.capacity else 0
    idx = (offs.to(rb.buf.device) + start) % rb.capacity
    return _split_rows(rb.buf.index_select(0, idx), rb.ns, rb.na)
