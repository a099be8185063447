"""Kernel K2: the NS advection term with the 2/3-rule mask, with the
Runge-Kutta stage arithmetic of the vorticity solver folded into its first
and last pass; its wrapper, its constants and its plain version.

Replaces ``distributedconvrl_pde_control_tpu/ops/pallas/ns_advection.py::
PallasAdvection2D._kernel``. The CUDA source is ``csrc/ns_advection.cu``
(its header comment gives the design and what bounds it); it is built with
nvcc for sm_90a at first use and called through a plain C interface.

Two entry points, for w (B, n, n) complex64 full spectra indexed [ky][kx]:

  * ``ns_advection(w, consts, lin=None, f=None)``: with no optional operand
    the TPU kernel's function, the masked advection term; with them the
    solver's right-hand side ``lin * w + advection(w) + f``, written by the
    kernel's last pass;
  * ``ns_rk4_substeps(w, consts, lin, f, dt, substeps)``: classical RK4
    substeps of that right-hand side. Every stage is one launch of the
    kernel: its first pass forms the stage state ``w + alpha * k_prev`` while
    it reads, and the fourth stage's last pass writes the combination
    ``w + dt/6 (k1 + 2 (k2 + k3) + k4)``. One call into the library makes
    all 4 * substeps launches.

On a CUDA tensor both launch the kernel or raise: there is no fallback, and
no ``torch.fft`` or matrix product on that path. ``NS_ADVECTION.launches``
grows by the kernel launches the library reports having issued. On a CPU
tensor they run ``ns_rhs_plain`` and ``ns_rk4_plain``: ``ns_advection_plain``
(the same function with complex ``torch.fft``) composed with the same
arithmetic in plain PyTorch.

Design of the wrapper. The constants are validated once, when
``AdvectionConstants`` is made, and their device pointers are kept on it; a
call checks only the tensors it is given. The (B, 2, n, n) scratch is kept
per device, stream and shape and reused: calls on one stream are ordered, so
a later call may overwrite what an earlier one has finished with.

Grid sizes. Every square grid n >= 8, by one of two routes (``route``), both
hand-written kernels of the same source:

  * "block", up to the grid whose lines fit one block's shared memory
    (``line_limit``: 4,304 for factors 2, 3 and 5, 4,008 odd; 2,641 / 2,527
    with a larger prime factor): a power of two runs radix-2 groups, any
    other n the mixed-radix passes of K1, with a generic stage for a prime
    factor above 5;
  * "device", above it: the line transforms run as levels that fit a block
    (a split of n or Bluestein, ``device_route.device_plan``) through device
    memory, one cooperative launch per call or stage, with a workspace for
    the packed products (and Bluestein's lines) kept like the scratch.

The one grid refused is one whose buffers do not fit the device's free
memory; the error names the bytes.

Within the block route, a stage runs one of two kernels, chosen from n, the
batch and what the card reports (its SM count, and how many clusters of each
size it holds at once) alone, with no option (``cluster_size``): where one
field's intermediates fit the shared memory of a thread-block cluster of at
most 16 blocks and the batch's clusters fill the card, the cluster route (one
cluster per field, its intermediates in distributed shared memory, no
scratch in device memory); everywhere else, batch 1 included, the
cooperative kernel. ``NS_ADVECTION.cluster_launches`` counts the cluster
route's launches, which ``launches`` includes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from distributedconvrl_pde_control_torch.ops.kernels import device_route
from distributedconvrl_pde_control_torch.ops.kernels.ks_kernel import has_generic_stage

SOURCE = "ns_advection.cu"
REPLACES = "distributedconvrl_pde_control_tpu/ops/pallas/ns_advection.py:70"
PACKED = 2  # u + i v and dw/dx + i dw/dy: the scratch holds one complex field each
MIN_N = 8
SMEM_TARGET = 98_304  # what a block takes at most here, so that two fit an SM
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
MIN_BLOCKS = 132  # one block per SM of an H100
CLUSTER_SIZES = tuple(range(1, 17))  # blocks of a cluster; above 8 the card's non-portable sizes
CLUSTER_THREADS, CLUSTER_STAGE = 512, 12  # a block's threads; column pairs each stages
# the cluster route runs where its blocks fill at least this share of the card's SMs over its
# waves: it won at 0.73 (256^2 and 96^2 at batch 16, 256^2 at 32) and lost at 0.55 (256^2 at
# batch 8) and below (chip_smoke.py's phase 12 times both routes in turns)
CLUSTER_FILL = 0.7


def twiddle_length(n: int) -> int:
    """Entries of the twiddle table: n/2 for even n (the kernel takes the
    second half by symmetry), n for odd n."""
    return n // 2 if n % 2 == 0 else n


# ------------------------------------------------------------- constants
@dataclasses.dataclass(frozen=True)
class AdvectionConstants:
    """Spectral operator arrays of one square grid on one device.

    kx varies along the last axis and ky along rows, (n, n) float32 each,
    as the reference solver holds them; `kx_vec`, `ky_vec` (n,) and the
    twiddle table (`twiddle_length(n)`, 2) are what the kernel reads beside
    `inv_k2` and `mask23`. What the kernel reads is validated here, once; `pointers`
    holds its device addresses in the order of the launch's arguments."""

    n: int
    kx: torch.Tensor
    ky: torch.Tensor
    k2: torch.Tensor
    inv_k2: torch.Tensor  # 0 at k = 0
    mask23: torch.Tensor  # 2/3 rule: 1 where |k_int| <= n//3 on both axes
    kx_vec: torch.Tensor
    ky_vec: torch.Tensor
    twiddle: torch.Tensor
    pointers: tuple = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        n, device = self.n, self.inv_k2.device
        read = (("kx_vec", self.kx_vec, (n,)), ("ky_vec", self.ky_vec, (n,)),
                ("inv_k2", self.inv_k2, (n, n)), ("mask23", self.mask23, (n, n)),
                ("twiddle", self.twiddle, (twiddle_length(n), 2)))
        for name, t, shape in read:
            if t.device != device or t.dtype != torch.float32:
                raise ValueError(f"K2 {name}: need float32 on {device}, got {t.dtype} on {t.device}")
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"K2 {name}: need a contiguous {shape}, got {tuple(t.shape)}")
        object.__setattr__(self, "pointers", tuple(t.data_ptr() for _, t, _ in read))

    @property
    def device(self) -> torch.device:
        return self.inv_k2.device


def advection_constants(kx: np.ndarray, ky: np.ndarray, device="cuda") -> AdvectionConstants:
    """Constants from the wavenumber vectors kx, ky (n,) of a square grid.

    The vectors are cast to float32 before k^2 is formed, as the reference
    does (`make_sharded_ops`, `PallasAdvection2D._consts`); the sign of the
    Nyquist entry is the caller's convention. The (n, n) arrays are made on
    `device` from the vectors (float32 products, sums and quotients, each
    rounded once: the values numpy gives), so that a large grid builds no
    host arrays."""
    n = len(kx)
    if len(ky) != n:
        raise ValueError(f"K2 takes square grids, got kx ({len(kx)},) and ky ({len(ky)},)")

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    kx_vec = dev(np.asarray(kx).astype(np.float32))
    ky_vec = dev(np.asarray(ky).astype(np.float32))
    kx_row = kx_vec[None, :].expand(n, n).contiguous()
    ky_col = ky_vec[:, None].expand(n, n).contiguous()
    k2 = ky_col * ky_col + kx_row * kx_row
    zero = k2 == 0.0
    inv_k2 = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, k2))
    ii = dev(np.abs(np.fft.fftfreq(n) * n) <= n // 3)
    mask = (ii[:, None] * ii[None, :]).contiguous()
    ang = 2.0 * np.pi * np.arange(twiddle_length(n)) / n
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return AdvectionConstants(n=n, kx=kx_row, ky=ky_col, k2=k2, inv_k2=inv_k2, mask23=mask,
                              kx_vec=kx_vec, ky_vec=ky_vec, twiddle=dev(twiddle))


def fftfreq_constants(n: int, lx: float = 1.0, device="cuda") -> AdvectionConstants:
    """The constants of `PallasAdvection2D._consts` (np.fft.fftfreq
    wavenumbers: the Nyquist entry is negative)."""
    k = (2.0 * np.pi * np.fft.fftfreq(n, d=lx / n)).astype(np.float32)
    return advection_constants(k, k, device)


# ----------------------------------------------------------------- plain
def ns_advection_plain(w: torch.Tensor, c: AdvectionConstants) -> torch.Tensor:
    """The advection term of w (..., n, n) complex64 with complex torch.fft.

    Full complex inverses with the real part taken, as the reference does
    (the signed Nyquist wavenumber stays in the derivatives), not
    irfft2/rfft2."""
    wr, wi = w.real, w.imag
    pr, pi = c.inv_k2 * wr, c.inv_k2 * wi
    u = torch.fft.ifft2(torch.complex(-c.ky * pi, c.ky * pr)).real
    v = torch.fft.ifft2(torch.complex(c.kx * pi, -c.kx * pr)).real
    dwdx = torch.fft.ifft2(torch.complex(-c.kx * wi, c.kx * wr)).real
    dwdy = torch.fft.ifft2(torch.complex(-c.ky * wi, c.ky * wr)).real
    return torch.fft.fft2(-u * dwdx - v * dwdy) * c.mask23


def ns_rhs_plain(w: torch.Tensor, c: AdvectionConstants, lin=None, f=None) -> torch.Tensor:
    """`ns_advection` with its optional operands in plain PyTorch:
    `ns_advection_plain`, then the arithmetic on interleaved float32 views,
    so that the real operator multiplies both components without a complex
    product, in the reference solver's order."""
    out = torch.view_as_real(ns_advection_plain(w, c))
    if lin is not None:
        out = torch.addcmul(out, lin[..., None], torch.view_as_real(w))
    if f is not None:
        out = out.add_(torch.view_as_real(f))
    return torch.view_as_complex(out)


def ns_rk4_plain(w: torch.Tensor, c: AdvectionConstants, lin: torch.Tensor, f: torch.Tensor,
                 dt: float, substeps: int) -> torch.Tensor:
    """`ns_rk4_substeps` in plain PyTorch: per substep four `ns_rhs_plain`
    and w + dt/6 (k1 + 2 (k2 + k3) + k4), in the reference's order."""
    def rhs(wv):
        return torch.view_as_real(ns_rhs_plain(torch.view_as_complex(wv), c, lin, f))

    wv = torch.view_as_real(w)
    for _ in range(substeps):
        k1 = rhs(wv)
        k2 = rhs(torch.add(wv, k1, alpha=0.5 * dt))
        k3 = rhs(torch.add(wv, k2, alpha=0.5 * dt))
        k4 = rhs(torch.add(wv, k3, alpha=dt))
        wv = torch.add(wv, (k1 + (k2 + k3).mul_(2.0)).add_(k4), alpha=dt / 6.0)
    return torch.view_as_complex(wv)


# ---------------------------------------------------------- launch shape
def _smem(which: int, n: int, tc: int, ppc: int, odd: bool, generic: bool) -> int:
    npad = n + (n >> 4)
    g = 2 if generic else 1
    lines = (2 * ppc * n + 4 * ppc * npad * g, npad * (2 * tc * g + tc // 2), ppc * npad * g)[which]
    return 8 * ((n if odd else n // 2) + lines)


def smem_bytes(which: int, n: int, tc: int, ppc: int) -> int:
    """Dynamic shared memory of pass `which` (0 rows inverse, 1 columns, 2
    rows forward), as `ns_advection_smem_bytes` in the source: the twiddle
    table and the padded lines (one spare point in 16), the lines twice
    where a generic stage runs out of place."""
    return _smem(which, n, tc, ppc, n % 2 == 1, has_generic_stage(n))


def line_limit(n: int) -> int:
    """The largest grid of n's kind (odd or even; with or without a prime
    factor above 5) whose lines fit one block at the narrowest launch shape
    (one row pair, two columns): pass 0, the widest, grows as 8.5 n float2
    (9 n for odd n), 4.25 n more with a generic stage."""
    odd, generic = n % 2 == 1, has_generic_stage(n)
    m = 8
    while _smem(0, m + 1, 2, 1, odd, generic) <= SMEM_LIMIT:
        m += 1
    return m


def column_tile(n: int, batch: int) -> int:
    """Columns per block of the column pass, even: as wide as the grid,
    shared memory and a full wave of blocks allow, so that the global
    accesses run long. Where it does not divide n, the grid's last tile is
    partial."""
    tc = 16
    while tc > 2 and (tc > n or smem_bytes(1, n, tc, 1) > SMEM_TARGET
                      or batch * -(-n // tc) < MIN_BLOCKS):
        tc //= 2
    return tc


def route(n: int) -> str:
    """"block" where every pass's lines fit one block at the narrowest
    launch shape (n up to ``line_limit``), else "device"."""
    return "block" if max(smem_bytes(i, n, 2, 1) for i in range(3)) <= SMEM_LIMIT else "device"


def cluster_smem_bytes(n: int, c: int) -> int:
    """Shared memory of a block of the cluster route at grid size n on
    clusters of c blocks (`ns_advection_cluster_smem_bytes` in the source), 0
    where one field does not fit them: the twiddles and n + n/16 rows of ld
    points (twice with a generic stage), ld the narrowest even row that holds
    both fields' tc = 2 ceil(n / 2c) columns and lets pass 1 lay the lines of
    its ppb = 2 ceil((n/2 + 1) / 2c) row pairs' mirror rows past the rows
    y <= n/2. A block also stages what it sends in a round of the exchange in
    registers: CLUSTER_STAGE column pairs a thread of CLUSTER_THREADS."""
    if n < 2 or not 1 <= c <= CLUSTER_SIZES[-1]:
        return 0
    npad, g = n + (n >> 4), 2 if has_generic_stage(n) else 1
    tw = twiddle_length(n) + twiddle_length(n) % 2  # X starts 16-byte aligned
    tc, ppb = 2 * -(-n // (2 * c)), 2 * -(-(n // 2 + 1) // (2 * c))
    top, ld = (n // 2 + 1) + ((n // 2 + 1) >> 4), 2 * tc
    while not 2 * ppb <= -(-top * ld // npad) <= ld - 2 * ppb:
        ld += 2
    smem = 8 * (tw + g * npad * ld)
    if smem > SMEM_LIMIT or 2 * ppb * ((n + 1) // 2) > CLUSTER_STAGE * CLUSTER_THREADS:
        return 0
    return smem


def cluster_size(n: int, batch: int, sms: int, resident) -> int:
    """Blocks per cluster of the cluster route for a (batch, n, n) stage, or 0
    for the cooperative kernel, from what the card reports: its SM count
    `sms` and `resident(c)`, how many clusters of c blocks it holds at once.
    Of the clusters that hold one field (and that the card can place), those
    that run the batch in the fewest waves, and of them the largest; the
    cluster route where its blocks fill at least CLUSTER_FILL of the card's
    SMs over those waves. 0 on the device route and where no cluster of up to
    16 blocks holds a field."""
    if route(n) != "block":
        return 0
    fits = [c for c in CLUSTER_SIZES if cluster_smem_bytes(n, c) and resident(c) > 0]
    if not fits:
        return 0
    waves = {c: -(-batch // resident(c)) for c in fits}
    c = max(fits, key=lambda c: (-waves[c], c))
    return c if batch * c >= CLUSTER_FILL * waves[c] * sms else 0


def check_grid(n: int) -> None:
    """Raises unless the kernel takes an n x n grid: n >= MIN_N (the route
    takes any larger n; only the device's memory bounds it)."""
    if n < MIN_N:
        raise ValueError(f"K2 takes grids of n >= {MIN_N}, got {n}")


def dm_work_floats(batch: int, n: int, plan: device_route.DevicePlan) -> int:
    """Floats of the device route's workspace (`ns_advection_dm_work_floats`
    in the source): the packed products (batch, n, ceil(n/2)) complex and,
    for Bluestein, one work line of m points per scratch row."""
    packed = 2 * batch * n * ((n + 1) // 2)
    return packed + (2 * PACKED * batch * n * plan.m if plan.bluestein else 0)


def row_pairs(n: int, batch: int) -> int:
    """Row pairs (r, -r) per block of the two row passes."""
    ppc = 4
    while ppc > 1 and (smem_bytes(0, n, 2, ppc) > SMEM_TARGET
                       or batch * -(-(n // 2 + 1) // ppc) < 2 * MIN_BLOCKS):
        ppc //= 2
    return ppc


def flops(n: int, batch: int) -> float:
    """Float32 operations the function needs. The four inverse transforms
    keep only their real parts and the forward transform takes a real field,
    so two complex inverses of packed pairs and one real-to-complex forward
    suffice: 2.5 complex 2D FFTs at 5*N*log2(N) flops for N = n*n points,
    plus ~30 flops per point for the spectral multiplies, the product and
    the mask. (The stage operands add ~10 flops per point and are not
    counted: the bound is that of the TPU kernel's function.)"""
    points = n * n
    return batch * (2.5 * 5.0 * points * np.log2(points) + 30.0 * points)


def min_bytes(n: int, batch: int) -> int:
    """Bytes the function must move: w read once, out written once."""
    return 16 * batch * n * n


# --------------------------------------------------------------- wrapper
class _NSAdvectionKernel:
    """Handle of the compiled kernel: lazy build, launches, launch count, and
    per device, stream and shape the scratch, the work fields and the launch
    shape kept between calls.

    `chain` picks the form of a stage of the block route on the card: one
    launch (the default, what every path runs: the cluster route where
    `cluster_size` gives one, else the cooperative kernel) or the chain of
    three launches (what the CPU tests emulate; timed beside the others by
    chip_smoke.py). The device route is one cooperative launch."""

    def __init__(self):
        self.launches = 0  # kernel launches, as the library counts them where it makes them
        self.cluster_launches = 0  # those of them on the cluster route
        self._lib = None
        # (device, stream, batch, n, SMEM_LIMIT, CLUSTER_FILL) -> [scratch or None, tc, ppc,
        # work or None, device route: (tables, workspace) or None, cluster size or 0]
        self._plans = {}

    def _load(self):
        if self._lib is None:
            from distributedconvrl_pde_control_torch.ops.kernels import build

            lib = build.load(SOURCE)
            ptr, f64, i32 = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
            lib.ns_advection_launch.argtypes = [ptr] * 10 + [i32] * 5 + [ptr] * 2
            lib.ns_advection_launch.restype = ctypes.c_int
            lib.ns_advection_rk4_launch.argtypes = [ptr] * 11 + [f64] + [i32] * 6 + [ptr] * 2
            lib.ns_advection_rk4_launch.restype = ctypes.c_int
            lib.ns_advection_dm_launch.argtypes = [ptr] * 9 + [i32] * 2 + [ptr, i32] + [ptr] * 7
            lib.ns_advection_dm_launch.restype = ctypes.c_int
            lib.ns_advection_dm_rk4_launch.argtypes = ([ptr] * 10 + [f64] + [i32] * 3
                                                       + [ptr, i32] + [ptr] * 7)
            lib.ns_advection_dm_rk4_launch.restype = ctypes.c_int
            lib.ns_advection_cluster_launch.argtypes = [ptr] * 9 + [i32] * 3 + [ptr] * 2
            lib.ns_advection_cluster_launch.restype = ctypes.c_int
            lib.ns_advection_cluster_rk4_launch.argtypes = ([ptr] * 10 + [f64] + [i32] * 4
                                                            + [ptr] * 2)
            lib.ns_advection_cluster_rk4_launch.restype = ctypes.c_int
            lib.ns_advection_cluster_capacity.argtypes = [i32] * 2
            lib.ns_advection_cluster_capacity.restype = ctypes.c_int
            lib.ns_advection_error_string.argtypes = [ctypes.c_int]
            lib.ns_advection_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _plan(self, w: torch.Tensor, c: AdvectionConstants):
        """Checks w against the constants; (plan, stream) of its shape."""
        device, n = w.device, c.n
        if device.type != "cuda":
            raise RuntimeError(f"K2 launches on CUDA tensors only, got {device}")
        if c.device != device:
            raise ValueError(f"K2 constants: need float32 on {device}, got them on {c.device}")
        if w.dim() != 3 or w.shape[1] != n or w.shape[2] != n or w.shape[0] < 1:
            raise ValueError(f"K2 w: need a contiguous complex64 (B, {n}, {n}), "
                             f"got {w.dtype} {tuple(w.shape)}")
        stream = torch.cuda.current_stream(device).cuda_stream
        key = (device.index, stream, w.shape[0], n, SMEM_LIMIT, CLUSTER_FILL)
        plan = self._plans.get(key)
        if plan is None:
            check_grid(n)
            batch = w.shape[0]
            self._load()
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            cluster = cluster_size(n, batch, sms, functools.partial(self._resident, n))
            if route(n) == "device":
                dplan = device_route.device_plan(n, SMEM_LIMIT)
                floats = dm_work_floats(batch, n, dplan)
                device_route.check_memory(
                    8 * PACKED * batch * n * n + 4 * floats + device_route.table_bytes(dplan),
                    device, f"K2 at n={n}, batch {batch}")
                dm = (device_route.device_tables(dplan, device),
                      torch.empty(floats, dtype=torch.float32, device=device))
                tc = ppc = 0
            else:
                dm, tc, ppc = None, column_tile(n, batch), row_pairs(n, batch)
            plan = self._plans[key] = [None, tc, ppc, None, dm, cluster]
        return plan, stream

    def _resident(self, n: int, c: int) -> int:
        """Clusters of c blocks at grid size n that the current card holds at
        once (`ns_advection_cluster_capacity`)."""
        got = self._lib.ns_advection_cluster_capacity(n, c)
        if got < 0:
            raise RuntimeError(f"K2 cluster capacity at n={n}, {c} blocks: "
                               f"{self._lib.ns_advection_error_string(-got).decode()}")
        return got

    @staticmethod
    def _scratch(plan, w: torch.Tensor) -> torch.Tensor:
        """The (B, 2, n, n) scratch of the routes that pass through device
        memory, made at their first launch of the shape."""
        if plan[0] is None:
            plan[0] = torch.empty((w.shape[0], PACKED, w.shape[1], w.shape[2]),
                                  dtype=torch.complex64, device=w.device)
        return plan[0]

    @staticmethod
    def _check(c: AdvectionConstants, lin, **fields):
        """The spectra w and f and the operator lin of one call."""
        shape, device = fields["w"].shape, fields["w"].device
        for name, t in fields.items():
            if t is not None and (t.dtype is not torch.complex64 or t.shape != shape
                                  or t.device != device or not t.is_contiguous()):
                raise ValueError(f"K2 {name}: need a contiguous complex64 {tuple(shape)} on "
                                 f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if lin is not None and (lin.dtype is not torch.float32 or lin.shape != c.inv_k2.shape
                                or lin.device != device or not lin.is_contiguous()):
            raise ValueError(f"K2 lin: need a contiguous float32 {tuple(c.inv_k2.shape)} on "
                             f"{device}, got {lin.dtype} {tuple(lin.shape)} on {lin.device}")

    def _count(self, err: int, launched: ctypes.c_int, cluster: bool = False):
        self.launches += launched.value
        if cluster:
            self.cluster_launches += launched.value
        if err:
            raise RuntimeError(
                f"K2 launch failed: {self._lib.ns_advection_error_string(err).decode()}")

    def __call__(self, w: torch.Tensor, c: AdvectionConstants, lin=None, f=None,
                 chain: bool = False) -> torch.Tensor:
        """`ns_advection`: one launch of the kernel (three with `chain`)."""
        plan, stream = self._plan(w, c)
        _, tc, ppc, _, dm, cluster = plan
        self._check(c, lin, w=w, f=f)
        out = torch.empty_like(w)
        launched = ctypes.c_int(0)
        if cluster and not chain:
            err = self._lib.ns_advection_cluster_launch(
                w.data_ptr(), *c.pointers, out.data_ptr(),
                None if lin is None else lin.data_ptr(), None if f is None else f.data_ptr(),
                w.shape[0], c.n, cluster, stream, ctypes.byref(launched))
            self._count(err, launched, cluster=True)
            return out
        scratch = self._scratch(plan, w)
        if dm is not None:
            if chain:
                raise ValueError(f"K2 at n={c.n} runs its device route, which has no chain form")
            err = self._lib.ns_advection_dm_launch(
                w.data_ptr(), *c.pointers[:4], scratch.data_ptr(), out.data_ptr(),
                None if lin is None else lin.data_ptr(), None if f is None else f.data_ptr(),
                w.shape[0], c.n, *_dm_args(dm), stream, ctypes.byref(launched))
            self._count(err, launched)
            return out
        err = self._lib.ns_advection_launch(
            w.data_ptr(), *c.pointers, scratch.data_ptr(), out.data_ptr(),
            None if lin is None else lin.data_ptr(), None if f is None else f.data_ptr(),
            w.shape[0], c.n, tc, ppc, not chain, stream, ctypes.byref(launched))
        self._count(err, launched)
        return out

    def rk4(self, w: torch.Tensor, c: AdvectionConstants, lin: torch.Tensor, f: torch.Tensor,
            dt: float, substeps: int, chain: bool = False) -> torch.Tensor:
        """`ns_rk4_substeps`: 4 * substeps launches of the kernel (three
        times as many with `chain`), made by one call into the library."""
        plan, stream = self._plan(w, c)
        if substeps < 1:
            raise ValueError(f"K2 rk4: need substeps >= 1, got {substeps}")
        if lin is None or f is None:
            raise ValueError("K2 rk4: needs lin and f")
        self._check(c, lin, w=w, f=f)
        if plan[3] is None:
            plan[3] = torch.empty((5, *w.shape), dtype=torch.complex64, device=w.device)
        _, tc, ppc, work, dm, cluster = plan
        out = torch.empty_like(w)
        launched = ctypes.c_int(0)
        if cluster and not chain:
            err = self._lib.ns_advection_cluster_rk4_launch(
                w.data_ptr(), *c.pointers, work.data_ptr(), out.data_ptr(), lin.data_ptr(),
                f.data_ptr(), dt, substeps, w.shape[0], c.n, cluster, stream,
                ctypes.byref(launched))
            self._count(err, launched, cluster=True)
            return out
        scratch = self._scratch(plan, w)
        if dm is not None:
            if chain:
                raise ValueError(f"K2 at n={c.n} runs its device route, which has no chain form")
            err = self._lib.ns_advection_dm_rk4_launch(
                w.data_ptr(), *c.pointers[:4], scratch.data_ptr(), work.data_ptr(),
                out.data_ptr(), lin.data_ptr(), f.data_ptr(), dt, substeps, w.shape[0], c.n,
                *_dm_args(dm), stream, ctypes.byref(launched))
            self._count(err, launched)
            return out
        err = self._lib.ns_advection_rk4_launch(
            w.data_ptr(), *c.pointers, scratch.data_ptr(), work.data_ptr(), out.data_ptr(),
            lin.data_ptr(), f.data_ptr(), dt, substeps, w.shape[0], c.n, tc, ppc,
            not chain, stream, ctypes.byref(launched))
        self._count(err, launched)
        return out


def _dm_args(dm) -> tuple:
    """The device route's plan, tables and workspace as the library takes them."""
    (desc, tw, pos, chirp, bh), work = dm
    return (desc.ctypes.data, len(desc), tw.data_ptr(), pos.data_ptr(), device_route.ptr(chirp),
            device_route.ptr(bh), work.data_ptr())


NS_ADVECTION = _NSAdvectionKernel()


def ns_advection(w: torch.Tensor, c: AdvectionConstants, lin=None, f=None) -> torch.Tensor:
    """The masked advection term of the spectra w (B, n, n) complex64, or
    with the optional operands lin (n, n) float32 and f (a spectrum like w)
    lin * w + advection(w) + f. The CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if w.device.type == "cpu":
        return ns_rhs_plain(w, c, lin, f)
    return NS_ADVECTION(w, c, lin, f)


def ns_rk4_substeps(w: torch.Tensor, c: AdvectionConstants, lin: torch.Tensor, f: torch.Tensor,
                    dt: float, substeps: int = 1) -> torch.Tensor:
    """`substeps` classical RK4 substeps of length dt of w' = lin * w +
    advection(w) + f on spectra w, f (B, n, n) complex64 with lin (n, n)
    float32: every stage is one launch of the kernel with its stage
    arithmetic folded in, and one call into the library makes them all, so
    that the host does per env step what it would do per stage. The CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if w.device.type == "cpu":
        return ns_rk4_plain(w, c, lin, f, dt, substeps)
    return NS_ADVECTION.rk4(w, c, lin, f, dt, substeps)
