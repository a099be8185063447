"""Host reads of packed chunk records.

Counterpart of ``distributedconvrl_pde_control_tpu/train/records.py``. The
chunked trainer returns one packed `(5, n_steps, n_envs)` f32 record array
per chunk (train/hooks.py REC_* row order). A read is split into a start
half and a consume half so that the chunk pipeline can queue more chunks
between them: the start half enqueues a non-blocking copy into pinned host
memory behind the chunk's kernels and records an event; the consume half
waits for that event alone (never for chunks queued later) and unpacks.

Two readers return the same dict in the same order:

* dense: the whole plane in one copy;
* sparse: a `(2, n_steps)` header (any-finished flag and mean reward per
  step), then only the finished steps' `(5, n_envs)` rows. The host
  accounting consumes nothing else: episodes are time-synchronized, so
  normally one step per chunk carries every finish, with extra rows only
  for blow-up terminations.

Dense is the default. On an NVIDIA H100 80GB HBM3 at 700 W the plane of the
largest shipped configuration (16384 envs x 50 steps, 16.4 MB) takes 2.4-7.0
ms to read when waited for at once and the sparse reader 0.4-0.6 ms, against
the 470-480 ms its chunk takes (chip_smoke.py phase 16, two runs); in the
pipeline the dense copy overlaps the chunks queued after it, while the sparse
reader's second read waits for all of them. The batched trainers read dense;
the mesh trainer (`parallel/multichip.py::train_sharded`) switches to the
sparse reader from `SPARSE_RECORDS_MIN_BYTES` on, the JAX package's switch.
"""

from __future__ import annotations

import numpy as np
import torch

from distributedconvrl_pde_control_torch.train.hooks import (
    REC_COMPLETED,
    REC_EP_REWARD,
    REC_ERRORED,
    REC_FINISHED,
    REC_MEAN_REWARD,
    unpack_records,
)


SPARSE_RECORDS_MIN_BYTES = 1 << 20  # the JAX package's dense/sparse switch


def record_bytes(n_steps: int, n_envs: int) -> int:
    return 5 * 4 * n_steps * n_envs


def _start_host_copy(t: torch.Tensor):
    """(host tensor, event or None): a non-blocking copy of a CUDA tensor
    into pinned memory with an event recorded behind it; a CPU tensor is
    its own host copy."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def start_record_read(packed: torch.Tensor, sparse: bool = False):
    """Kick off the device-to-host work for one chunk's records; returns an
    opaque handle for `consume_record_read`. Call at dispatch time (before
    queueing more chunks) so the copy overlaps device compute."""
    if not sparse:
        host, event = _start_host_copy(packed)
        return (False, packed, host, event)
    header = torch.stack([
        (packed[REC_FINISHED] > 0.5).any(dim=1).to(torch.float32),
        packed[REC_MEAN_REWARD, :, 0],
    ])
    host, event = _start_host_copy(header)
    return (True, packed, host, event)


def consume_record_read(handle) -> dict:
    """Finish a record read: the dict form `PDEHook.feed_episode_records`
    consumes (finished/completed/ep_reward/errored, over finished steps only
    on the sparse path: same values, same step-major order) plus the full
    `(n_steps,)` mean_reward vector either way."""
    is_sparse, packed, host, event = handle
    if event is not None:
        event.synchronize()
    if not is_sparse:
        return unpack_records(host)
    h = host.numpy()
    mean_reward = h[1]
    idx = np.flatnonzero(h[0] > 0.5)
    if idx.size:
        rows = packed.index_select(1, torch.as_tensor(idx, device=packed.device)).cpu().numpy()
    else:
        rows = np.zeros((5, 0, packed.shape[2]), np.float32)
    return {
        "finished": rows[REC_FINISHED] > 0.5,
        "completed": rows[REC_COMPLETED] > 0.5,
        "ep_reward": rows[REC_EP_REWARD],
        "errored": rows[REC_ERRORED] > 0.5,
        "mean_reward": mean_reward,
    }
