"""A (dp, sp) mesh of ranks under ``torch.distributed``, and its launcher.

Counterpart of ``distributedconvrl_pde_control_tpu/parallel/mesh.py``
(`make_dp_sp_mesh`) and of the collectives the JAX package's sharded code
calls inside `shard_map` (`psum`, `pmax`, `pmean`, the tiled `all_to_all`,
`ppermute` on a ring). Where JAX maps one program over the devices of a
mesh, here each device is a process (a rank): rank r holds the mesh
position (dp_idx, sp_idx) = divmod(r, sp), runs the same Python code as
every other rank, and reaches the collectives through process groups:

  * the sp group of its row (the ranks that share one dp index), over which
    fields are sharded and sensor dots summed;
  * the dp group of its column (the ranks that share one sp index), over
    which gradients and episode counts are reduced;
  * the mesh's own group, for broadcasts from rank 0.

The backend is NCCL when every rank has a card of its own (``cuda:<rank>``)
and gloo on CPU ranks. A mesh built without process groups (`RankMesh()`,
or a (dp, sp) tuple handed to a trainer) is a mesh of one rank whose
collectives are identities; a mesh of several ranks without groups can be
built and inspected, and raises at its first collective. As in the JAX
package, whose meshes take `jax.devices()`, a mesh is on the card unless the
caller asks for the CPU: `RankMesh` defaults to device "cuda" and `launch`
to the NCCL backend; CPU ranks are `device="cpu"` and `backend="gloo"`.

`launch(fn, dp, sp, ...)` runs `fn(mesh, *args)` on dp * sp ranks and
returns rank 0's result: a mesh of one rank runs in the calling process
through a process group of one, larger meshes run in processes started
with the `spawn` method (never `fork`: the caller may hold threads). The
group's store is a `FileStore` under a directory the caller names, and its
timeout bounds every collective, so that a rank that waits for a peer
which never comes fails within the timeout instead of hanging. A rank that
raises ends the run: the launcher stops the others and raises with the
rank's traceback. A healthy run has no wall-clock limit unless the caller
sets one (`deadline_s`). Rank 0's printed lines reach the caller's stdout
as they are written.

Deadlock rules the sharded code keeps: every rank reaches every collective
of its groups in the same order, and no rank branches on a value that only
it has read back (a value read back is first reduced over the group whose
ranks must agree on it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import sys
import time
import uuid
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 120.0  # default bound on any collective of a launched mesh


def make_dp_sp_mesh(n: int, sp: Optional[int] = None) -> tuple[int, int]:
    """(dp, sp) of `n` ranks. `sp` defaults to the JAX package's rule: the
    largest power of two up to 4 that divides `n`, enough spatial shards to
    run the transpose transforms while keeping a dp axis."""
    if sp is None:
        sp = 1
        while sp < 4 and n % (sp * 2) == 0:
            sp *= 2
    if n % sp:
        raise ValueError(f"{n} ranks do not divide over sp={sp}")
    return n // sp, sp


def fold_seed(seed: int, dp_idx: int) -> int:
    """The seed of dp group `dp_idx`'s stream: the port's `fold_in`."""
    return (seed + 0x9E3779B97F4A7C15 * (dp_idx + 1)) % (1 << 64)


@dataclasses.dataclass(eq=False)
class RankMesh:
    """This rank's place in a (dp, sp) mesh, its device and its groups."""

    dp: int = 1
    sp: int = 1
    dp_idx: int = 0
    sp_idx: int = 0
    device: str = "cuda"
    dp_group: Any = None
    sp_group: Any = None
    group: Any = None  # every rank of the mesh
    root: int = 0  # the global rank of mesh rank 0

    @property
    def shape(self) -> tuple[int, int]:
        return self.dp, self.sp

    @property
    def rank(self) -> int:
        """This rank's index in the mesh, dp-major."""
        return self.dp_idx * self.sp + self.sp_idx

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def _axis(self, axis: str):
        group, n, idx = ((self.dp_group, self.dp, self.dp_idx) if axis == "dp" else
                         (self.sp_group, self.sp, self.sp_idx))
        if group is None and n > 1:
            raise RuntimeError(f"a collective over {axis} of {n} ranks needs the mesh's process "
                               "groups (parallel.mesh.launch)")
        return group, n, idx

    # ----------------------------------------------------------- reductions
    def _reduce(self, x: torch.Tensor, axis: str, op) -> torch.Tensor:
        group, _, _ = self._axis(axis)
        if group is None:
            return x
        if x.dtype == torch.bool:  # no bool on NCCL
            return self._reduce(x.to(torch.int32), axis, op).to(torch.bool)
        y = torch.view_as_real(x).clone() if x.is_complex() else x.clone()
        dist.all_reduce(y, op, group=group)
        return torch.view_as_complex(y) if x.is_complex() else y

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._reduce(x, axis, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._reduce(x, axis, dist.ReduceOp.MAX)

    def pmean(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self.psum(x, axis) / self._axis(axis)[1]

    # ------------------------------------------------------------ exchanges
    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """JAX's tiled `all_to_all`: `x` is split into n blocks along
        `split_axis`, block j goes to rank j of the group, and the blocks
        received are concatenated along `concat_axis` in rank order.
        `all_to_all_single` exchanges along dim 0 only, so the split axis is
        moved to the front and made contiguous first."""
        group, n, _ = self._axis(axis)
        if group is None:
            return x
        s, c = split_axis % x.ndim, concat_axis % x.ndim
        xr = torch.view_as_real(x) if x.is_complex() else x
        k = xr.shape[s] // n
        send = xr.unflatten(s, (n, k)).movedim(s, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        out = recv.movedim(0, c).flatten(c, c + 1)
        return torch.view_as_complex(out.contiguous()) if x.is_complex() else out

    def all_gather(self, x: torch.Tensor, axis: str) -> list:
        """Every rank's `x` over the group, in rank order."""
        group, n, _ = self._axis(axis)
        if group is None:
            return [x]
        xr = (torch.view_as_real(x) if x.is_complex() else x).contiguous()
        parts = [torch.empty_like(xr) for _ in range(n)]
        dist.all_gather(parts, xr, group=group)
        return [torch.view_as_complex(p) for p in parts] if x.is_complex() else parts

    def ppermute(self, x: torch.Tensor, axis: str, shift: int) -> torch.Tensor:
        """A ring shift: rank i receives the `x` of rank (i - shift) mod n,
        JAX's `ppermute` with the permutation i -> i + shift. The blocks
        this moves are boundary rows, so it gathers them all."""
        _, n, idx = self._axis(axis)
        return self.all_gather(x, axis)[(idx - shift) % n]

    def gather_cat(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The blocks of the group concatenated along `dim` in rank order:
        a dp-sharded array made whole on every rank."""
        parts = self.all_gather(x, axis)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    def broadcast_object(self, obj):
        """Mesh rank 0's `obj` (any picklable value) on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.root, group=self.group,
                                   device=torch.device(self.device) if self.backend == "nccl"
                                   else None)
        return box[0]


def _group_cache(timeout: datetime.timedelta):
    cache = {}

    def group(ranks: tuple):
        if ranks not in cache:  # every rank asks for the same tuples in the same order
            cache[ranks] = dist.new_group(list(ranks), timeout=timeout)
        return cache[ranks]

    return group


def make_rank_mesh(dp: int, sp: int, device: str, ranks: Optional[list] = None,
                   timeout_s: float = TIMEOUT_S) -> Optional[RankMesh]:
    """The mesh of `ranks` (default the first dp * sp ranks of the default
    group) as this rank sees it, or None on a rank outside it. Every rank of
    the default group must call it with the same arguments: group creation
    is itself collective."""
    ranks = list(range(dp * sp)) if ranks is None else list(ranks)
    if len(ranks) != dp * sp:
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} ranks, got {len(ranks)}")
    group = _group_cache(datetime.timedelta(seconds=timeout_s))
    sp_groups = [group(tuple(ranks[d * sp:(d + 1) * sp])) for d in range(dp)]
    dp_groups = [group(tuple(ranks[s::sp])) for s in range(sp)]
    whole = group(tuple(ranks))
    me = dist.get_rank()
    if me not in ranks:
        return None
    d, s = divmod(ranks.index(me), sp)
    return RankMesh(dp, sp, d, s, device, dp_groups[s], sp_groups[d], whole, ranks[0])


# ------------------------------------------------------------------ launcher
def _init(backend: str, store_path: str, rank: int, world: int, timeout_s: float) -> None:
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _rank_entry(rank: int, world: int, dp: int, sp: int, backend: str, store_path: str,
                timeout_s: float, call_path: str, result_path: str, out_path: str) -> None:
    """One spawned rank: its group, its mesh, `fn(mesh, *args)` as pickled
    in `call_path`, and on rank 0 the result. Rank 0 prints to `out_path`,
    which the launcher passes on to its own stdout."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        device = "cpu"
    with open(call_path, "rb") as f:
        fn, args = pickle.load(f)
    _init(backend, store_path, rank, world, timeout_s)
    try:
        with contextlib.ExitStack() as stack:
            if rank == 0:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(out_path, "w", buffering=1))))
            mesh = make_rank_mesh(dp, sp, device, timeout_s=timeout_s)
            result = fn(mesh, *args)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


class _Forward:
    """Passes the complete lines that a file has gained on to stdout."""

    def __init__(self, path: str):
        self.path, self.pos = path, 0

    def __call__(self, final: bool = False) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            f.seek(self.pos)
            data = f.read()
        if not final:
            data = data[:data.rfind(b"\n") + 1]
        if data:
            self.pos += len(data)
            sys.stdout.write(data.decode(errors="replace"))
            sys.stdout.flush()


def launch(fn: Callable, dp: int, sp: int, *args, backend: str = "nccl", store_dir: str,
           timeout_s: float = TIMEOUT_S, deadline_s: Optional[float] = None):
    """`fn(mesh, *args)` on each rank of a dp x sp mesh; returns rank 0's
    result. `backend` "nccl" gives rank r the card cuda:r, "gloo" CPU ranks.
    `store_dir` holds the group's FileStore, the pickled call (read by each
    rank from the file: a pipe per process is slow for large arguments),
    rank 0's printed lines and its pickled result for the run's length.
    One rank runs in this process; more are spawned, rank 0's lines are
    printed here as they come, and the run fails if any rank raises (a
    collective that a peer never joins raises after `timeout_s`) or, where
    `deadline_s` is given, if the ranks have not ended within it."""
    world = dp * sp
    os.makedirs(store_dir, exist_ok=True)
    tag = uuid.uuid4().hex[:12]
    store_path = os.path.join(store_dir, f".rank_store_{tag}")
    call_path = os.path.join(store_dir, f".rank_call_{tag}.pkl")
    result_path = os.path.join(store_dir, f".rank_result_{tag}.pkl")
    out_path = os.path.join(store_dir, f".rank_out_{tag}.txt")
    forward = _Forward(out_path)
    try:
        if world == 1:
            if dist.is_initialized():
                raise RuntimeError("a process group is already initialized in this process")
            device = "cuda" if backend == "nccl" else "cpu"
            _init(backend, store_path, 0, 1, timeout_s)
            try:
                return fn(make_rank_mesh(dp, sp, device, timeout_s=timeout_s), *args)
            finally:
                dist.destroy_process_group()
        import torch.multiprocessing as mp

        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(_rank_entry, args=(world, dp, sp, backend, store_path, timeout_s,
                                                    call_path, result_path, out_path),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        while not ctx.join(timeout=0.5):
            forward()
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"the {dp}x{sp} mesh's ranks did not end in {deadline_s:.0f} s")
        with open(result_path, "rb") as f:
            return pickle.load(f)
    finally:
        forward(final=True)
        for path in (store_path, call_path, result_path, out_path):
            if os.path.exists(path):
                os.remove(path)
