"""Minimal JLD2 reader for importing the reference's shipped checkpoints.

A copy of ``distributedconvrl_pde_control_tpu/utils/jld2.py`` with h5py
imported when a file is read, so that the module imports without it.

JLD2 (the Julia serialization format used by the reference's `save()/load()`,
scripts/KS/setup/KSSetup.jl:378-402) writes standard HDF5 files: Julia structs
become HDF5 compound types whose fields are either inline scalars or object
references, and Julia arrays become plain datasets with REVERSED dimension
order (HDF5 is row-major, Julia column-major). This module reads that subset
with h5py — enough to extract trained Flux networks, scalar hyperparameters,
and reward histories from `agent.jld2` / `hook.jld2`. It does NOT implement
full JLD2 (custom-committed datatypes like StableRNG's UInt128 state are
skipped as `Unreadable`).

Pure host-side IO: nothing here touches a device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Unreadable", "load_jld2", "julia_array", "julia_matrix"]

_MAX_DEPTH = 24


class Unreadable:
    """Placeholder for a leaf h5py cannot map (e.g. UInt128 RNG state)."""

    def __init__(self, why: str):
        self.why = why

    def __repr__(self):  # pragma: no cover
        return f"<Unreadable {self.why}>"


def _h5py():
    """h5py, imported at first use."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is required for JLD2 import and is not installed") from e
    return h5py


def _deref(f, x, depth=0):
    h5py = _h5py()
    if depth > _MAX_DEPTH:
        return Unreadable("max depth")
    try:
        if isinstance(x, h5py.Reference):
            obj = f[x]
            if isinstance(obj, h5py.Dataset):
                return _deref(f, obj[()], depth + 1)
            return {k: _deref(f, obj[k], depth + 1) for k in obj}
        if isinstance(x, h5py.Dataset):
            return _deref(f, x[()], depth + 1)
        if isinstance(x, np.void):  # compound scalar = Julia struct
            return {n: _deref(f, x[n], depth + 1) for n in x.dtype.names}
        if isinstance(x, bytes):
            return x.decode("utf-8", errors="replace")
        if isinstance(x, np.ndarray):
            if x.dtype.names:
                return {n: _deref(f, x[n], depth + 1) for n in x.dtype.names}
            if x.dtype.kind == "O":
                out = [_deref(f, e, depth + 1) for e in x.ravel()]
                return out[0] if x.size == 1 else out
            return x
        return x
    except Exception as e:  # unreadable committed datatype
        return Unreadable(f"{type(e).__name__}: {e}")


def load_jld2(path: str, root: str | None = None):
    """Read a JLD2 file into nested dicts/arrays/scalars.

    `root`: top-level variable name (e.g. "agent", "hook"); None loads every
    top-level variable (except JLD2's internal `_types` group) into a dict.
    """
    with _h5py().File(path, "r") as f:
        if root is not None:
            return _deref(f, f[root])
        return {k: _deref(f, f[k]) for k in f if k != "_types"}


def julia_array(a) -> np.ndarray:
    """A Julia N-d array as numpy with Julia's dimension order restored.

    JLD2 stores a Julia (d1, ..., dn) array as an HDF5 dataset of shape
    (dn, ..., d1); transposing recovers indexing parity with the Julia code.
    """
    a = np.asarray(a)
    return a.T if a.ndim > 1 else a


# Flux Dense stores weight as (out, in) — same as models/mlp.py's convention.
julia_matrix = julia_array
