"""The device-memory route of kernels K1 and K2: line transforms of lines
that do not fit one block's shared memory, through a workspace in device
memory.

Below its shared-memory limit each kernel keeps whole lines in a block (the
block route). Above it the same wrapper launches the kernel's second set of
CUDA functions (``csrc/dm_fft.cuh`` and the ``*_dm_*`` kernels of each
source), which compute the same function with every line transform split
into levels that do fit a block:

  * a split: n = L_0 * L_1 (* L_2), each level within a block's reach. The
    line is read as a row-major array [L_0][L_1][L_2]; the inverse runs the
    L_a-point transforms along axis a for a = 0, 1, ..., each followed by
    the twiddles exp(+2 pi i k_a r / N_a) (r the position along the axes
    after a, N_a = L_a * L_(a+1) * ...); the forward runs the mirror image.
    Each level is one pass over device memory. The inverse leaves point
    j = j_0 + L_0 j_1 + L_0 L_1 j_2 at position j_0 S_0 + j_1 S_1 + j_2 S_2
    (S_a the product of the levels after a, `real_positions`) and the
    forward takes it back from there, so no pass permutes data: the kernels'
    real-space work is pointwise.
  * Bluestein, where no split works (n prime above a level's reach, say):
    the length-n DFT is a circular convolution of length m >= 2n - 1, m
    5-smooth, computed by a split transform of length m: the data times the
    chirp exp(+-i pi j^2 / n), an inverse of length m, the product with the
    inverse transform of the conjugate chirp (`bh`), a forward of length m,
    and the chirp again. Its real-space order is the natural one.

Everything that depends on the grid alone is made here, on the host, in
float64: the levels and their tiles (`device_plan`), the twiddle table
exp(2 pi i r / m), each level's digit-reversed positions, the chirp (angles
reduced modulo 2n in integers before the float64 sine and cosine) and the
convolution kernel's spectrum (`host_tables`). The kernels read them cast to
float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

MAX_LEVELS = 3
MAX_TILE = 16  # sub-lines a block transforms at once, so that strided reads run 16 points long
SMEM_TARGET = 98_304  # what a block of the device route takes at most where it can: two per SM
RADICES = (2, 3, 5)  # Bluestein's m has only these prime factors


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """How a line of n points is transformed through device memory.

    `levels` multiply to `m` (= n for a split, Bluestein's m otherwise);
    `tiles[a]` is log2 of the sub-lines one block takes at level a; `smem`
    the dynamic shared memory of a block (its largest level)."""

    n: int
    m: int
    bluestein: bool
    levels: tuple
    tiles: tuple
    smem: int

    @property
    def strides(self) -> tuple:
        """S_a: the product of the levels after a."""
        return tuple(math.prod(self.levels[a + 1:]) for a in range(len(self.levels)))


def _factor_radices(n: int) -> list:
    from distributedconvrl_pde_control_torch.ops.kernels.ks_kernel import factor_radices

    return factor_radices(n)


def _generic(n: int) -> bool:
    return any(r > 5 for r in _factor_radices(n))


def level_smem(length: int, tile: int, generic: bool) -> int:
    """Dynamic shared memory of a block at one level (`level_smem` in
    csrc/dm_fft.cuh): the level's twiddles and positions and `tile` lines,
    twice where a generic stage runs out of place."""
    return 8 * length + 4 * (length + length % 2) + 8 * length * tile * (2 if generic else 1)


def level_cap(smem_limit: int) -> int:
    """The longest level a block can take at one sub-line per block, with a
    generic stage."""
    cap = smem_limit // 28
    while cap > 2 and level_smem(cap, 1, True) > smem_limit:
        cap -= 1
    return cap


def _divisors(n: int) -> list:
    small = [d for d in range(1, math.isqrt(n) + 1) if n % d == 0]
    return sorted(set(small + [n // d for d in small]))


def split_levels(n: int, cap: int, count: int):
    """The most even split of n into `count` levels, each in [2, cap] (the
    largest level as small as possible), or None."""
    if count == 1:
        return (n,) if 2 <= n <= cap else None
    best = None
    for d in _divisors(n):
        if d < 2 or d > cap:
            continue
        rest = split_levels(n // d, cap, count - 1)
        if rest is not None:
            cand = (d, *rest)
            if best is None or max(cand) < max(best):
                best = cand
    return best


def _split(n: int, cap: int):
    for count in range(2, MAX_LEVELS + 1):
        levels = split_levels(n, cap, count)
        if levels is not None:
            return levels
    return None


def smooth_at_least(x: int) -> int:
    """The smallest number >= x whose prime factors are 2, 3 and 5."""
    m = x
    while True:
        rest = m
        for r in RADICES:
            while rest % r == 0:
                rest //= r
        if rest == 1:
            return m
        m += 1


def device_plan(n: int, smem_limit: int) -> DevicePlan:
    """The device route's plan for lines of n points, with a block's shared
    memory at most `smem_limit` bytes: a split of n into 2 or 3 levels where
    one exists, else Bluestein with the smallest 5-smooth m >= 2n - 1 that
    splits."""
    if n < 2:
        raise ValueError(f"a line transform needs n >= 2, got {n}")
    cap = level_cap(smem_limit)
    levels, m, bluestein = _split(n, cap), n, False
    if levels is None:
        bluestein, m = True, smooth_at_least(2 * n - 1)
        while (levels := _split(m, cap)) is None:
            m = smooth_at_least(m + 1)
    target = min(SMEM_TARGET, smem_limit)
    tiles = []
    for length in levels:
        g, lgt = _generic(length), 0
        while 2 << lgt <= MAX_TILE and level_smem(length, 2 << lgt, g) <= target:
            lgt += 1
        tiles.append(lgt)
    smem = max(level_smem(length, 1 << t, _generic(length)) for length, t in zip(levels, tiles))
    if smem > smem_limit:
        raise ValueError(f"no level plan of n={n} fits {smem_limit} B of shared memory")
    return DevicePlan(n=n, m=m, bluestein=bluestein, levels=tuple(levels), tiles=tuple(tiles),
                      smem=smem)


def real_positions(plan: DevicePlan) -> np.ndarray:
    """Where the inverse transform leaves point j of a line (and where the
    forward takes it from): sum_a j_a S_a with j = j_0 + L_0 j_1 + ...; the
    identity for Bluestein."""
    j = np.arange(plan.n, dtype=np.int64)
    if plan.bluestein:
        return j
    pos = np.zeros(plan.n, np.int64)
    for length, stride in zip(plan.levels, plan.strides):
        pos += (j % length) * stride
        j //= length
    return pos


def _positions(plan: DevicePlan) -> list:
    from distributedconvrl_pde_control_torch.ops.kernels.ks_kernel import digit_reversed_positions

    return [digit_reversed_positions(length, _factor_radices(length)).astype(np.int64)
            for length in plan.levels]


def host_tables(plan: DevicePlan) -> dict:
    """The tables the device route reads, in float64 (int64 positions):

    twiddle (m, 2): (cos, sin)(2 pi r / m), the exact zeros kept exact;
    pos: each level's digit-reversed positions, one after another;
    chirp (n, 2): (cos, sin)(pi j^2 / n) for Bluestein, else None;
    bh (2, m, 2): for Bluestein, the inverse transform over m of the
      convolution kernel, divided by m, for the inverse and the forward
      direction, in the order in which the innermost level's inverse
      stages leave it (position q L + pos[i] holds the point of position
      q L + i of the real-space order of the length-m transform); else None.
    """
    m = plan.m
    ang = 2.0 * np.pi * np.arange(m) / m
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    tw[np.abs(tw) < 1e-12] = 0.0
    pos = _positions(plan)
    out = {"twiddle": tw, "pos": np.concatenate(pos), "chirp": None, "bh": None}
    if not plan.bluestein:
        return out
    n = plan.n
    j = np.arange(n, dtype=np.int64)
    chirp = np.exp(1j * np.pi * ((j * j) % (2 * n)) / n)  # exp(+i pi j^2 / n)
    split = dataclasses.replace(plan, n=m, bluestein=False)
    scrambled = real_positions(split)
    inner, slots = plan.levels[-1], pos[-1]
    bh = []
    for c in (chirp, np.conj(chirp)):  # the inverse direction's chirp, then the forward's
        b = np.zeros(m, np.complex128)
        b[:n] = np.conj(c)
        b[m - n + 1:] = np.conj(c[1:])[::-1]
        spec = np.fft.ifft(b)  # the unscaled inverse over m, divided by m
        in_order = np.empty(m, np.complex128)
        in_order[scrambled] = spec
        slot = np.empty(m, np.complex128)
        base = np.arange(0, m, inner)[:, None]
        slot[(base + slots[None, :]).ravel()] = in_order[(base + np.arange(inner)[None, :]).ravel()]
        bh.append(np.stack([slot.real, slot.imag], axis=1))
    out["chirp"] = np.stack([chirp.real, chirp.imag], axis=1)
    out["bh"] = np.stack(bh)
    return out


def descriptor(plan: DevicePlan) -> np.ndarray:
    """The plan as the sources read it (`dm::make_plan`): n, m, bluestein,
    levels, then per level its length, log2 tile, stage count and stages
    (K1's `factor_radices`)."""
    desc = [plan.n, plan.m, int(plan.bluestein), len(plan.levels)]
    for length, lgt in zip(plan.levels, plan.tiles):
        radices = _factor_radices(length)
        desc += [length, lgt, len(radices), *radices]
    return np.asarray(desc, dtype=np.int32)


def table_bytes(plan: DevicePlan) -> int:
    """Device bytes of the float32 tables."""
    return 8 * plan.m + 4 * sum(plan.levels) + (8 * plan.n + 16 * plan.m if plan.bluestein else 0)


def device_tables(plan: DevicePlan, device):
    """(descriptor, twiddle, pos, chirp or None, bh or None) with the tables
    on `device` as float32 / int32 tensors."""
    import torch

    tables = host_tables(plan)

    def dev(a, dtype=torch.float32):
        return None if a is None else torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                                      device=device)

    return (descriptor(plan), dev(tables["twiddle"]), dev(tables["pos"], torch.int32),
            dev(tables["chirp"]), dev(tables["bh"]))


def ptr(t) -> int | None:
    """A tensor's device address for ctypes, None for None."""
    return None if t is None else t.data_ptr()


def check_memory(need: int, device, what: str) -> None:
    """Raises unless `need` bytes fit what `device` has free (the caching
    allocator's unused blocks included)."""
    import torch

    free, total = torch.cuda.mem_get_info(device)
    avail = free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    if need > avail:
        raise ValueError(f"{what} needs {need} B of device memory for its device route's "
                         f"workspace and tables, above the {avail} B available on {device} "
                         f"({total} B in all)")
