"""Plots, frames and the live terminal view of rollouts.

A copy of ``distributedconvrl_pde_control_tpu/viz/plotting.py`` (the
matplotlib/ffmpeg rebuild of the reference's `src/plotting.jl`), with
matplotlib imported inside the drawing functions, so that the module imports
where matplotlib is missing. `f2fplot`, `_as_real_field` and `live_view`
need only numpy.

  * plot_heat     - space-time heatmaps of field, forcing, reward
                    (plotting.jl:4-169)
  * plot_sensors  - sensor/actuator kernel shapes (plotting.jl:171-186)
  * plot_sums     - sum(|y|), sum(|p|) time series (plotting.jl:188-249)
  * plot_actions  - per-actuator action traces (plotting.jl:251-304)
  * plot_rewards  - reward landscape over a (y, action) grid
                    (plotting.jl:526-541)
  * render_animation - frame dump + ffmpeg mp4 (plotrun, plotting.jl:306-521)
  * live_view     - in-terminal live animation (the headless equivalent of
                    plotrun's Blink window, plotting.jl:306-521)
  * f2fplot       - periodic-domain closure for display (fluid_rk4.jl:231-240)
  * plot_energy   - fluid energy traces vs baselines (testrun eval)

All functions take host-side traces (from train.eval.rollout or
hook.best_trace) and return the matplotlib Figure; pass `path` to save.
Without matplotlib a drawing function raises ImportError naming it
(`MATPLOTLIB_MISSING`); `have_matplotlib()` asks first.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

MATPLOTLIB_MISSING = "matplotlib is not installed"


def have_matplotlib() -> bool:
    """Whether the drawing functions can run here."""
    import importlib.util

    try:
        return importlib.util.find_spec("matplotlib") is not None
    except ValueError:  # a module entry set to None (blocked)
        return False


def _plt():
    """matplotlib.pyplot on the Agg backend, imported at first use."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{MATPLOTLIB_MISSING}: the plots need it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, path: Optional[str]):
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        _plt().close(fig)
    return fig


def _as_real_field(y: np.ndarray) -> np.ndarray:
    """Spectral (complex) traces -> real space; real traces pass through."""
    if np.iscomplexobj(y):
        return np.fft.ifft2(y, axes=(-2, -1)).real
    return y


def plot_heat(traces: dict, path: Optional[str] = None, from_step: int = 0,
              to_step: Optional[int] = None, title: str = "",
              plot_separate: bool = False):
    """Space-time heatmaps of y(x,t), forcing p(x,t) and reward(t) for 1D
    fields; the plot_heat panel layout of plotting.jl:146-158.

    `from_step`/`to_step` window the trace (the reference's `from`/`to`
    kwargs, plotting.jl:4); `plot_separate=True` writes each panel as its
    own figure `<stem>_{y,p,reward}.png` (plot_separate, plotting.jl:4)."""
    plt = _plt()
    y = np.asarray(traces["y"])[from_step:to_step]
    p = np.asarray(traces["forcing"])[from_step:to_step]
    r = np.asarray(traces["reward"])[from_step:to_step]
    if y.ndim == 3 and y.shape[1] == 2:  # Keller-Segel two-field: plot u
        y = y[:, 0]
        p = p if p.ndim == 2 else p
    if plot_separate:
        stem, ext = (os.path.splitext(path) if path else ("heat", ".png"))
        outs = []
        for arr, name, cmap in ((y, "y", "RdBu_r"), (p, "p", "PiYG"),
                                (r, "reward", "viridis")):
            fig, ax = plt.subplots(figsize=(10, 4))
            im = ax.imshow(arr.T, aspect="auto", origin="lower", cmap=cmap,
                           interpolation="nearest")
            ax.set_xlabel("step")
            ax.set_ylabel("x" if name != "reward" else "actuator")
            ax.set_title(f"{name} {title}")
            fig.colorbar(im, ax=ax)
            outs.append(_finish(fig, f"{stem}_{name}{ext}" if path else None))
        return outs
    fig, axes = plt.subplots(3, 1, figsize=(10, 9), sharex=True)
    im0 = axes[0].imshow(y.T, aspect="auto", origin="lower", cmap="RdBu_r",
                         interpolation="nearest")
    axes[0].set_ylabel("x")
    axes[0].set_title(f"field y {title}")
    fig.colorbar(im0, ax=axes[0])
    im1 = axes[1].imshow(p.T, aspect="auto", origin="lower", cmap="PiYG",
                         interpolation="nearest")
    axes[1].set_ylabel("x")
    axes[1].set_title("forcing p")
    fig.colorbar(im1, ax=axes[1])
    im2 = axes[2].imshow(r.T, aspect="auto", origin="lower", cmap="viridis",
                         interpolation="nearest")
    axes[2].set_ylabel("actuator")
    axes[2].set_xlabel("step")
    axes[2].set_title("reward")
    fig.colorbar(im2, ax=axes[2])
    return _finish(fig, path)


def plot_sensors(kernels: np.ndarray, path: Optional[str] = None):
    """Kernel shapes (plotting.jl:171-186)."""
    plt = _plt()
    kernels = np.asarray(kernels)
    fig, ax = plt.subplots(figsize=(9, 4))
    if kernels.ndim == 2:
        for i, k in enumerate(kernels):
            ax.plot(k, lw=1, label=f"k{i}" if len(kernels) <= 12 else None)
        if len(kernels) <= 12:
            ax.legend()
    else:  # 2D kernels: show the union
        ax.imshow(kernels.sum(axis=0), cmap="magma")
    ax.set_title("sensor/actuator kernels")
    return _finish(fig, path)


def plot_sums(traces: dict, path: Optional[str] = None):
    """sum(|y|) and sum(|p|) vs time (plotting.jl:188-249)."""
    plt = _plt()
    y = _as_real_field(np.asarray(traces["y"]))
    p = np.asarray(traces["forcing"])
    if np.iscomplexobj(p):
        p = np.fft.ifft2(p, axes=(-2, -1)).real
    t = np.asarray(traces.get("time", np.arange(len(y))))
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.plot(t, np.abs(y.reshape(len(y), -1)).sum(axis=1), label="sum |y|")
    ax.plot(t, np.abs(p.reshape(len(p), -1)).sum(axis=1), label="sum |p|")
    ax.set_xlabel("t")
    ax.legend()
    ax.set_title("field and forcing magnitude")
    return _finish(fig, path)


def plot_actions(traces: dict, path: Optional[str] = None, max_actuators: int = 16):
    """Per-actuator action traces (plotting.jl:251-304)."""
    plt = _plt()
    a = np.asarray(traces["action"])  # (steps, rows, n_act)
    a = a[:, 0, :] if a.ndim == 3 else a
    fig, ax = plt.subplots(figsize=(9, 4))
    for i in range(min(a.shape[1], max_actuators)):
        ax.plot(a[:, i], lw=0.8)
    ax.set_xlabel("step")
    ax.set_ylabel("action")
    ax.set_title(f"actions (first {min(a.shape[1], max_actuators)} actuators)")
    return _finish(fig, path)


def plot_rewards_curve(rewards: Sequence[float], path: Optional[str] = None,
                       bestepisode: Optional[int] = None):
    """Training reward curve (the hook's terminal plot, PDEhook.jl:100-102)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.plot(np.asarray(rewards))
    if bestepisode:
        ax.axvline(bestepisode - 1, color="r", ls="--", lw=0.8, label="best")
        ax.legend()
    ax.set_xlabel("episode")
    ax.set_ylabel("total reward")
    ax.set_title("reward per episode")
    return _finish(fig, path)


def plot_reward_landscape(reward_fn, y_range, a_range, n: int = 101,
                          path: Optional[str] = None):
    """Reward over a (y, action) grid (plot_rewards, plotting.jl:526-541).

    `reward_fn(y_scalar, a_scalar) -> float` is setup-specific.
    """
    plt = _plt()
    ys = np.linspace(*y_range, n)
    As = np.linspace(*a_range, n)
    Z = np.asarray([[float(reward_fn(y, a)) for a in As] for y in ys])
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(Z, origin="lower", aspect="auto",
                   extent=[a_range[0], a_range[1], y_range[0], y_range[1]], cmap="viridis")
    ax.set_xlabel("action")
    ax.set_ylabel("y")
    fig.colorbar(im, ax=ax)
    ax.set_title("reward landscape")
    return _finish(fig, path)


def plot_energy(energies: dict, path: Optional[str] = None):
    """Fluid energy traces: trained vs baselines (testrun eval,
    FluidSetup.jl:497-500 + Fluid_8.jl:28)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 4))
    for label, e in energies.items():
        ax.plot(np.asarray(e), label=label)
    ax.set_xlabel("step")
    ax.set_ylabel("sum |omega| / (nx*ny)")
    ax.legend()
    ax.set_title("energy")
    return _finish(fig, path)


def f2fplot(f: np.ndarray) -> np.ndarray:
    """Close the periodic domain for display: the solvers work on
    [0,Lx)×[0,Ly) grids that exclude x=Lx / y=Ly, so plots of the raw field
    show a one-cell seam at the wrap boundary. Appends the first column and
    then the first row (1D: the first sample) so the rendered field covers
    the closed domain — `f2fplot`, the reference's src/fluid_rk4.jl:231-240.
    """
    f = np.asarray(f)
    if f.ndim == 1:
        return np.concatenate([f, f[:1]])
    f = np.concatenate([f, f[:, :1]], axis=1)
    return np.concatenate([f, f[:1, :]], axis=0)


def render_animation(traces: dict, out_dir: str, fps: int = 16,
                     filename: str = "output.mp4") -> Optional[str]:
    """Frame dump + ffmpeg assembly (plotrun/testrun video path,
    plotting.jl:486-510, FluidSetup.jl:533-536). Returns the mp4 path, or
    None if ffmpeg is unavailable (frames are still written)."""
    plt = _plt()
    frames_dir = os.path.join(out_dir, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    y = _as_real_field(np.asarray(traces["y"]))
    if y.ndim == 3 and y.shape[1] == 2:  # Keller-Segel two-field: animate u
        y = y[:, 0]
    vmax = np.abs(y).max() or 1.0
    for i, frame in enumerate(y):
        fig, ax = plt.subplots(figsize=(6, 5))
        if frame.ndim == 1:
            ax.plot(f2fplot(frame))
            ax.set_ylim(-vmax, vmax)
        else:
            ax.imshow(f2fplot(frame), cmap="RdBu_r", vmin=-vmax, vmax=vmax)
        ax.set_title(f"step {i}")
        fig.savefig(os.path.join(frames_dir, f"a{i:04d}.png"), dpi=80)
        plt.close(fig)
    if shutil.which("ffmpeg") is None:
        return None
    out_path = os.path.join(out_dir, filename)
    subprocess.run(
        ["ffmpeg", "-y", "-framerate", str(fps), "-i",
         os.path.join(frames_dir, "a%04d.png"), "-c:v", "libx264", "-crf", "21",
         "-an", "-pix_fmt", "yuv420p", out_path],
        check=True, capture_output=True,
    )
    return out_path


def live_view(traces: dict, fps: float = 16.0, width: int = 96,
              height: int = 20, out=None, max_frames: Optional[int] = None,
              loop: bool = False) -> int:
    """Live in-terminal animation of a rollout — the headless-native
    equivalent of the reference's live Blink window
    (`plotrun`, the reference's src/plotting.jl:306-521; `testrun`'s live
    heatmap, scripts/Fluid/setup/FluidSetup.jl:436-519).

    The reference pops an Electron window and streams PlotlyJS frames into
    it; on a headless TPU host there is no display server, so the live
    channel that actually exists is the terminal. 1D fields render as an
    ASCII line plot (field amplitude vs x), 2D fields as a downsampled
    unicode intensity map; frames redraw in place via ANSI cursor movement
    at `fps`. Returns the number of frames drawn.

    `out`: stream to draw to (default sys.stdout; anything non-TTY gets the
    frames without sleeps, so piping/tests are instant). `loop` replays the
    trace until interrupted (the live-window watch mode).
    """
    import sys
    import time

    stream = out if out is not None else sys.stdout
    is_tty = bool(getattr(stream, "isatty", lambda: False)())
    y = _as_real_field(np.asarray(traces["y"]))
    if y.ndim == 3 and y.shape[1] == 2:  # Keller-Segel two-field: show u
        y = y[:, 0]
    r = np.asarray(traces.get("reward")) if "reward" in traces else None
    t = np.asarray(traces.get("time")) if "time" in traces else None
    vmax = float(np.abs(y).max()) or 1.0
    ramp = " .:-=+*#%@"
    n_frames = len(y) if max_frames is None else min(len(y), max_frames)
    lines_per_frame = height + 1

    def _frame_lines(frame: np.ndarray) -> list:
        if frame.ndim == 1:
            f = f2fplot(frame)
            xs = np.linspace(0, len(f) - 1, width).astype(int)
            cols = f[xs]
            # row 0 = +vmax ... bottom row = -vmax
            rows = np.clip(((vmax - cols) / (2 * vmax) * (height - 1)).round()
                           .astype(int), 0, height - 1)
            grid = np.full((height, width), " ", dtype="<U1")
            grid[rows, np.arange(width)] = "o"
            grid[height // 2, :] = np.where(grid[height // 2, :] == "o",
                                            "o", ".")
            return ["".join(row) for row in grid]
        f = f2fplot(frame)
        ys = np.linspace(0, f.shape[0] - 1, height).astype(int)
        xs = np.linspace(0, f.shape[1] - 1, width).astype(int)
        sub = f[np.ix_(ys, xs)]
        lvl = np.clip((np.abs(sub) / vmax * (len(ramp) - 1)).astype(int),
                      0, len(ramp) - 1)
        chars = np.asarray(list(ramp))
        return ["".join(row) for row in chars[lvl]]

    drawn = 0
    try:
        while True:
            for i in range(n_frames):
                hdr = f"step {i:4d}"
                if t is not None and i < len(t):
                    hdr += f"  t={float(t[i]):7.3f}"
                if r is not None and i < len(r):
                    hdr += f"  mean reward {float(np.mean(r[i])):+.4f}"
                lines = [hdr.ljust(width)] + _frame_lines(y[i])
                stream.write("\n".join(lines) + "\n")
                drawn += 1
                if is_tty:
                    stream.flush()
                    time.sleep(1.0 / max(fps, 1e-3))
                    if i < n_frames - 1 or loop:
                        stream.write(f"\x1b[{lines_per_frame}F")
            if not (loop and is_tty):
                break
    except KeyboardInterrupt:
        pass
    if is_tty:
        stream.write("\n")
        stream.flush()
    return drawn


def plot_waterfall(traces: dict, path: Optional[str] = None, stride: int = 10,
                   max_lines: int = 60):
    """3D waterfall of a 1D field's evolution — the `plotrun(plot3D=true)`
    view (plotting.jl:306-521)."""
    plt = _plt()
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

    y = _as_real_field(np.asarray(traces["y"]))
    if y.ndim == 3 and y.shape[1] == 2:
        y = y[:, 0]
    idx = np.arange(0, len(y), stride)[:max_lines]
    fig = plt.figure(figsize=(9, 6))
    ax = fig.add_subplot(projection="3d")
    x = np.arange(y.shape[-1])
    for rank, i in enumerate(idx):
        ax.plot(x, np.full_like(x, float(i), dtype=float), y[i], lw=0.8,
                color=plt.cm.viridis(rank / max(len(idx) - 1, 1)))
    ax.set_xlabel("x")
    ax.set_ylabel("step")
    ax.set_zlabel("y")
    ax.set_title("field evolution")
    return _finish(fig, path)
