"""The port's tooling against the JAX package on the CPU: plots, frames and
the live view; the JLD2 reader and the reference import; `--import-jld2` on
the CLI's three branches; bounded retries; the profiler and the step timer.

The reference's own JLD2 checkpoints are not in the repository, so the
readers are held to each other on synthetic files with JLD2's layout: Julia
structs as HDF5 compound scalars whose fields are inline scalars or object
references, arrays stored with their dimensions reversed, and the internal
`_types` group.
"""

import io
import json
import os
import sys
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch

from distributedconvrl_pde_control_tpu.train import checkpoint as jckpt
from distributedconvrl_pde_control_tpu.train import reference_import as jref
from distributedconvrl_pde_control_tpu.train.loop import init_train_state
from distributedconvrl_pde_control_tpu.utils import jld2 as jjld2
from distributedconvrl_pde_control_tpu.viz import plotting as jplot
from distributedconvrl_pde_control_torch.configs import ks as tks
from distributedconvrl_pde_control_torch.experiments import run as trun
from distributedconvrl_pde_control_torch.train import checkpoint
from distributedconvrl_pde_control_torch.train import reference_import as tref
from distributedconvrl_pde_control_torch.utils import jld2 as tjld2
from distributedconvrl_pde_control_torch.utils import profiling, resilience
from distributedconvrl_pde_control_torch.viz import plotting as tplot

ROOT = Path(__file__).resolve().parent.parent


def _traces(kind: str, steps: int = 6, seed: int = 0) -> dict:
    """Rollout-shaped traces: a KS field (steps, 192), a Keller-Segel pair
    (steps, 2, 100) or a fluid field (steps, 32, 32)."""
    rng = np.random.default_rng(seed)
    shape = {"ks": (192,), "kss": (2, 100), "fluid": (32, 32)}[kind]
    return {"y": rng.standard_normal((steps,) + shape).astype(np.float32),
            "forcing": rng.standard_normal((steps, shape[-1])).astype(np.float32),
            "action": rng.uniform(-1, 1, (steps, 1, 8)).astype(np.float32),
            "reward": rng.standard_normal((steps, 8)).astype(np.float32),
            "time": 0.1 * np.arange(1, steps + 1)}


# ---------------------------------------------------------------- plotting
@pytest.mark.parametrize("kind", ["ks", "kss", "fluid"])
def test_f2fplot_and_live_view_match_jax(kind):
    """`f2fplot` returns JAX's array and `live_view` writes JAX's text byte for
    byte to a non-TTY stream, one frame per step."""
    tr = _traces(kind)
    frame = tr["y"][0, 0] if kind == "kss" else tr["y"][0]
    np.testing.assert_array_equal(tplot.f2fplot(frame), jplot.f2fplot(frame))
    outs = []
    for mod in (tplot, jplot):
        buf = io.StringIO()
        assert mod.live_view(tr, out=buf, width=40, height=8) == len(tr["y"])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("step") == len(tr["y"])


def test_every_plot_writes_its_file(tmp_path):
    """Each drawing function writes its file (plot_heat also per panel), and
    `render_animation` writes one frame per step and returns the mp4's path
    only where ffmpeg exists."""
    tr = _traces("ks")
    tplot.plot_heat(tr, str(tmp_path / "heat.png"), title="KS22", from_step=1, to_step=5)
    tplot.plot_heat(tr, str(tmp_path / "sep.png"), plot_separate=True)
    tplot.plot_sums(tr, str(tmp_path / "sums.png"))
    tplot.plot_actions(tr, str(tmp_path / "actions.png"))
    tplot.plot_rewards_curve([-3.0, -2.0, -1.5], str(tmp_path / "rewards.png"), 3)
    tplot.plot_energy({"trained": [3.0, 2.0], "no action": [3.0, 3.1]},
                      str(tmp_path / "energy.png"))
    tplot.plot_sensors(np.eye(4, 16), str(tmp_path / "sensors.png"))
    tplot.plot_reward_landscape(lambda y, a: -y * y - a * a, (-1, 1), (-1, 1), n=5,
                                path=str(tmp_path / "landscape.png"))
    tplot.plot_waterfall(tr, str(tmp_path / "waterfall.png"), stride=2)
    for name in ("heat", "sep_y", "sep_p", "sep_reward", "sums", "actions", "rewards", "energy",
                 "sensors", "landscape", "waterfall"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0, name
    out = tplot.render_animation(_traces("fluid", steps=3), str(tmp_path / "video"), fps=4)
    assert sorted(os.listdir(tmp_path / "video" / "frames")) == [
        "a0000.png", "a0001.png", "a0002.png"]
    assert (out is None) == (tplot.shutil.which("ffmpeg") is None)


def test_plotting_names_matplotlib_when_it_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not tplot.have_matplotlib()
    with pytest.raises(ImportError, match="matplotlib"):
        tplot.plot_sums(_traces("ks"))
    assert tplot.live_view(_traces("ks"), out=io.StringIO()) == 6


# ------------------------------------------------------------ the JLD2 layout
def _chain_sizes(setup):
    return setup.agent.actor_layer_sizes, setup.agent.critic_layer_sizes


def _random_chain(rng, sizes):
    return [{"w": rng.standard_normal((o, i)).astype(np.float32),
             "b": rng.standard_normal(o).astype(np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])]


class _Writer:
    """Writes Julia values the way JLD2 lays them out in HDF5."""

    def __init__(self, f):
        self.f, self.n = f, 0

    def dataset(self, value) -> h5py.Reference:
        """An array (dimensions reversed) or a scalar as its own dataset."""
        self.n += 1
        value = np.asarray(value)
        ds = self.f.create_dataset(f"_data/{self.n}", data=value.T if value.ndim > 1 else value)
        return ds.ref

    def struct(self, fields: dict, name=None) -> h5py.Reference:
        """A Julia struct: one compound scalar, references for non-scalars."""
        self.n += 1
        items = []
        for k, v in fields.items():
            if isinstance(v, h5py.Reference):
                items.append((k, h5py.ref_dtype, v))
            elif isinstance(v, bytes):
                items.append((k, f"S{len(v)}", v))
            elif isinstance(v, (int, np.integer)):
                items.append((k, np.int64, v))
            else:
                items.append((k, np.float64, v))
        dtype = np.dtype([(k, t) for k, t, _ in items])
        value = np.array(tuple(v for _, _, v in items), dtype=dtype)
        ds = self.f.create_dataset(name or f"_data/{self.n}", data=value)
        return ds.ref

    def chain(self, chain) -> h5py.Reference:
        """A Flux Chain: struct(model=struct(layers=group of Dense structs))."""
        self.n += 1
        layers = self.f.create_group(f"_data/layers{self.n}")
        for i, layer in enumerate(chain, start=1):
            fields = {"weight": self.dataset(layer["w"]), "bias": self.dataset(layer["b"])}
            dtype = np.dtype([(k, h5py.ref_dtype) for k in fields])
            layers.create_dataset(str(i), data=np.array(tuple(fields.values()), dtype=dtype))
        return self.struct({"model": self.struct({"layers": layers.ref})})

    def refs(self, refs: list) -> h5py.Reference:
        """A Julia vector of boxed values: an object-reference array."""
        self.n += 1
        ds = self.f.create_dataset(f"_data/{self.n}", (len(refs),), dtype=h5py.ref_dtype)
        ds[...] = refs
        return ds.ref


def write_reference_saves(saves_dir: Path, setup, seed: int = 0, with_agent: bool = True):
    """saves/hook.jld2 (bestNNA, reward history, a best-episode DataFrame) and,
    with `with_agent`, saves/agent.jld2 (the four networks and the policy's
    scalars) for `setup`'s network sizes. Returns the chains written."""
    rng = np.random.default_rng(seed)
    actor_sizes, critic_sizes = _chain_sizes(setup)
    nets = {"best": _random_chain(rng, actor_sizes),
            "actor": _random_chain(rng, actor_sizes), "critic": _random_chain(rng, critic_sizes),
            "target_actor": _random_chain(rng, actor_sizes),
            "target_critic": _random_chain(rng, critic_sizes)}
    saves_dir.mkdir(parents=True, exist_ok=True)
    steps, nx, n_act = 5, setup.env.y0.shape[-1], setup.env.action_shape[-1]
    with h5py.File(saves_dir / "hook.jld2", "w") as f:
        f.create_group("_types").create_dataset("00000001", data=np.arange(3))
        w = _Writer(f)
        cols = {"timestep": np.arange(1, steps + 1, dtype=np.float64),
                "y": rng.standard_normal((steps, nx)), "p": rng.standard_normal((steps, nx)),
                "action": rng.uniform(-1, 1, (steps, n_act)),
                "reward": rng.standard_normal((steps, n_act))}
        lookup = [w.struct({"first": k.encode(), "second": i + 1}) for i, k in enumerate(cols)]
        # a DataFrame column: a vector of numbers, or of per-step vectors (boxed, by reference)
        columns = [w.dataset(v) if v.ndim == 1 else w.refs([w.dataset(row) for row in v])
                   for v in cols.values()]
        df = w.struct({"columns": w.refs(columns),
                       "colindex": w.struct({"lookup": w.refs(lookup)})})
        w.struct({"bestNNA": w.chain(nets["best"]), "bestreward": -1.25, "bestepisode": 7,
                  "rewards": w.dataset(np.linspace(-9.0, -1.0, 9)),
                  "rewards_compare": w.dataset(np.linspace(-9.0, -1.25, 8)),
                  "errored_episodes": w.dataset(np.array([2, 5], np.int64)),
                  "bestDF": df}, name="hook")
    if with_agent:
        with h5py.File(saves_dir / "agent.jld2", "w") as f:
            f.create_group("_types")
            w = _Writer(f)
            policy = w.struct({"behavior_actor": w.chain(nets["actor"]),
                               "behavior_critic": w.chain(nets["critic"]),
                               "target_actor": w.chain(nets["target_actor"]),
                               "target_critic": w.chain(nets["target_critic"]),
                               "y": 0.99, "p": 0.995, "batch_size": 3, "act_limit": 1.0,
                               "act_noise": 0.6, "update_loops": 20})
            w.struct({"policy": policy}, name="agent")
    return nets, cols


def _same_chain(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g["w"]), w["w"])
        np.testing.assert_array_equal(np.asarray(g["b"]), w["b"])


@pytest.fixture(scope="module")
def ks22_saves(tmp_path_factory):
    setup = tks.build_ks(tks.KS22, device="cpu")
    d = tmp_path_factory.mktemp("ref") / "KS22" / "saves"
    nets, cols = write_reference_saves(d, setup)
    return setup, d, nets, cols


def test_both_readers_read_the_jld2_layout(ks22_saves):
    """Chains, hook info, agent networks and scalars, warm start and the best
    trace: the port's reader gives the JAX reader's values, and both give
    what was written (Julia's (out, in) weights, reversed dimensions)."""
    _, d, nets, cols = ks22_saves
    assert set(tjld2.load_jld2(str(d / "hook.jld2"))) == set(
        jjld2.load_jld2(str(d / "hook.jld2"))) == {"hook", "_data"}
    (tchain, tinfo), (jchain, jinfo) = (m.load_reference_best_actor(str(d)) for m in (tref, jref))
    _same_chain(tchain, nets["best"])
    _same_chain(jchain, nets["best"])
    assert set(tinfo) == set(jinfo)
    for k in tinfo:
        np.testing.assert_array_equal(np.asarray(tinfo[k]), np.asarray(jinfo[k]))
    assert tinfo["bestreward"] == -1.25 and tinfo["bestepisode"] == 7
    tagent, jagent = tref.load_reference_agent(str(d)), jref.load_reference_agent(str(d))
    assert tagent["hyper"] == jagent["hyper"] and tagent["hyper"]["act_noise"] == 0.6
    for name, key in (("actor", "actor"), ("critic", "critic"), ("target_actor", "target_actor"),
                      ("target_critic", "target_critic")):
        _same_chain(tagent[name], nets[key])
        _same_chain(jagent[name], nets[key])
    twarm, jwarm = tref.load_warm_start(str(d)), jref.load_warm_start(str(d))
    assert set(twarm) == set(jwarm) == {"actor", "critic", "target_actor", "target_critic"}
    ttrace, jtrace = tref.load_reference_best_trace(str(d)), jref.load_reference_best_trace(str(d))
    assert set(ttrace) == set(jtrace) == {"y", "forcing", "action", "reward"}
    for k in ttrace:
        np.testing.assert_array_equal(ttrace[k], jtrace[k])
    np.testing.assert_allclose(ttrace["forcing"], cols["p"].astype(np.float32))
    assert tjld2.julia_array(np.ones((2, 3))).shape == (3, 2)


def test_jld2_reader_names_h5py_when_it_is_missing(monkeypatch, ks22_saves):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tjld2.load_jld2(str(ks22_saves[1] / "hook.jld2"))


def test_import_checkpoint_is_read_by_both_packages(ks22_saves, tmp_path):
    """`import_reference_checkpoint` writes the light checkpoint: both
    packages' `checkpoint.load` read the imported networks, the bestNNA and
    the reward history; without agent.jld2 the bestNNA is the actor."""
    setup, d, nets, _ = ks22_saves
    out = str(tmp_path / "imported")
    ts, hook = tref.import_reference_checkpoint(str(d), setup, out_dir=out)
    assert ts.agent.act_noise == pytest.approx(0.6)
    tts, thook = checkpoint.load(out, setup.agent, device="cpu")
    from distributedconvrl_pde_control_tpu import configs as C

    jsetup = C.build_ks(C.KS22)
    jts, jhook = jckpt.load(out, init_train_state(jsetup.env, jsetup.agent,
                                                  jax.random.PRNGKey(0)))
    for name, key in (("actor", "actor"), ("critic", "critic"), ("target_actor", "target_actor")):
        _same_chain([{"w": w.detach(), "b": b.detach()}
                     for w, b in zip(getattr(tts.agent, name).w, getattr(tts.agent, name).b)],
                    nets[key])
        _same_chain(getattr(jts.agent, name), nets[key])
    for h in (thook, jhook):
        _same_chain(h.best_actor, nets["best"])
        assert h.bestreward == -1.25 and h.bestepisode == 7 and len(h.rewards) == 9
        assert h.ep == 10 and list(h.errored_episodes) == [2, 5]
    assert float(jts.agent.act_noise) == pytest.approx(0.6)
    # only hook.jld2 (the agent's blob missing): the bestNNA is actor and target actor
    solo = tmp_path / "solo" / "saves"
    solo.mkdir(parents=True)
    (solo / "hook.jld2").write_bytes((d / "hook.jld2").read_bytes())
    ts2, _ = tref.import_reference_checkpoint(str(solo), setup)
    for chain in (ts2.agent.actor, ts2.agent.target_actor):
        np.testing.assert_array_equal(chain.w[0].detach().numpy(), nets["best"][0]["w"])
    with pytest.raises(ValueError, match="do not match"):
        tref.import_reference_checkpoint(str(d), tks.build_ks_global(device="cpu"))


def test_cli_import_jld2_on_eval_resume_and_batched(ks22_saves, tmp_path, capsys):
    """`--import-jld2` converts the save into --out and evaluates its bestNNA,
    continues it with `--train --resume` (the episode count goes on from the
    reference's), and warm-starts `--train --batched` from its networks."""
    _, d, nets, _ = ks22_saves
    out = str(tmp_path / "eval")
    trun.main(["KS22", "--eval", "--cpu", "--import-jld2", str(d), "--out", out, "--p-te", "2",
               "--p-t-action", "1"])
    text = capsys.readouterr().out
    assert "imported reference JLD2" in text
    assert set(json.loads(text.strip().splitlines()[-1])) == {
        "pre_control_mean_abs_dev", "post_control_mean_abs_dev", "suppression"}
    _same_chain(checkpoint.load_best_actor(out), nets["best"])
    assert (Path(out) / "heat.png").exists()
    res = str(tmp_path / "resume")
    trun.main(["KS22", "--train", "--resume", "--cpu", "--import-jld2", str(d), "--loops", "1",
               "--no-steps", "6", "--config-overrides", '{"te": 0.3}', "--out", res])
    assert "resuming from imported reference JLD2" in capsys.readouterr().out
    hook = checkpoint.load_hook(res)
    assert hook.ep == 12 and hook.rewards[:9] == list(np.linspace(-9.0, -1.0, 9))
    assert (Path(res) / "rewards.png").exists()
    bat = str(tmp_path / "batched")
    trun.main(["KS22", "--train", "--batched", "--cpu", "--import-jld2", str(d), "--n-envs", "2",
               "--total-steps", "2", "--chunk-len", "2", "--learner-batch", "8", "--capacity",
               "1024", "--out", bat])
    assert "warm-starting from imported reference JLD2" in capsys.readouterr().out
    assert (Path(bat) / "saves" / "agent_light.msgpack").exists()
    with pytest.raises(SystemExit, match="--import-jld2 is read by"):
        trun.main(["KS22", "--train", "--cpu", "--import-jld2", str(d)])
    # what the flag hands train_batched: every network spliced in, the actor as the first best
    from distributedconvrl_pde_control_torch.train.batched import (
        BatchedTrainer,
        BatchedTrainerConfig,
        train_batched,
    )

    setup = tks.build_ks(tks.KS22, device="cpu")
    trainer = BatchedTrainer(setup.env, setup.agent, BatchedTrainerConfig(n_envs=2, batch_size=8),
                             random_init=setup.random_init)
    ts, _, _ = train_batched(trainer, total_steps=0, warm_start=tref.load_warm_start(str(d)))
    for name in ("actor", "critic", "target_actor", "target_critic"):
        chain = getattr(ts.agent, name)
        _same_chain([{"w": w.detach(), "b": b.detach()} for w, b in zip(chain.w, chain.b)],
                    nets[name])
    _same_chain([{"w": w.detach(), "b": b.detach()} for w, b in zip(ts.best_actor.w,
                                                                      ts.best_actor.b)],
                nets["actor"])


# ----------------------------------------------------------------- resilience
def test_hard_deadline_prints_and_exits_non_zero():
    """A process stuck past its hard deadline prints the callback's line and
    ends with `DEADLINE_EXIT`, not 0."""
    import subprocess

    code = ("import time\n"
            "from distributedconvrl_pde_control_torch.utils import resilience\n"
            "resilience.arm_hard_deadline(0.5, lambda: print('deadline line'))\n"
            "time.sleep(30)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=str(ROOT))
    assert res.returncode == resilience.DEADLINE_EXIT != 0
    assert res.stdout.strip() == "deadline line"


def test_bench_torch_exits_non_zero_with_an_error_line(monkeypatch, capsys):
    """When its one attempt fails, bench_torch.py prints its one JSON line
    with value 0 and the error, and exits non-zero (the JAX bench exits 0)."""
    import bench_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_torch, "card", lambda: ("a card", "700.00 W"))

    def fail(tier):
        raise RuntimeError(f"simulated failure at {tier}")

    monkeypatch.setattr(bench_torch, "run_once", fail)
    assert bench_torch.main(["--tier", "tp"]) != 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["tier"] == "tp" and "simulated failure" in line["error"]
    monkeypatch.setattr(bench_torch, "run_once", lambda tier: 1234.5)
    assert bench_torch.main([]) == 0
    assert json.loads(capsys.readouterr().out.strip())["value"] == 1234.5


def test_bench_torch_deadline_prints_the_error_line_and_exits_non_zero():
    """A bench_torch.py measurement that hangs past `BENCH_DEADLINE_S` ends
    with its one JSON line, value 0 and the deadline's error, and exits
    `DEADLINE_EXIT`."""
    import subprocess

    code = ("import sys, time, torch\n"
            "import bench_torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "bench_torch.card = lambda: ('a card', '700.00 W')\n"
            "bench_torch.run_once = lambda tier: time.sleep(30)\n"
            "sys.exit(bench_torch.main(['--tier', 'tp']))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=str(ROOT), env={**os.environ, "BENCH_DEADLINE_S": "1"})
    assert res.returncode == resilience.DEADLINE_EXIT != 0
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["tier"] == "tp" and "hard deadline" in line["error"]


# ------------------------------------------------------------------ profiling
def test_trace_and_step_timer(tmp_path):
    """`trace` writes a Chrome trace holding the block's operators and their
    `annotate`d span; `StepTimer` counts and sums its phases."""
    timer = profiling.StepTimer()

    @profiling.annotate("the_block")
    def work(x):
        return torch.fft.rfft(x).abs().sum()

    with profiling.trace(str(tmp_path / "profile")):
        for _ in range(3):
            with timer.phase("work", block_on=[work(torch.ones(64))]):
                pass
    events = json.loads((tmp_path / "profile" / profiling.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "the_block" in names and any("fft" in str(n) for n in names)
    assert timer.counts["work"] == 3 and timer.totals["work"] > 0
    assert timer.summary().startswith("work")


def _ks_control_step():
    """A tiny KS control step: the deterministic actor on the observation,
    then the env's step (K1's plain version on the CPU)."""
    setup = tks.build_ks(tks.KS22, device="cpu")
    agent, acfg = setup.agent, setup.agent.cfg
    astate = agent.init_state(torch.Generator().manual_seed(0), "cpu")
    st = setup.env.reset()

    def step():
        obs = st.obs.permute(1, 0, 2).reshape(acfg.ns, acfg.n_actuators)
        a = agent.act(astate, obs, learning=False)
        return setup.env.step(st, a.reshape(acfg.na_rows, 1, acfg.n_actuators).permute(1, 0, 2))

    return step


def _ks_train_chunk():
    """A tiny batched KS train chunk whose last step is the first to learn;
    returns it and the actor's first weight."""
    from distributedconvrl_pde_control_torch.train.batched import (
        BatchedTrainer,
        BatchedTrainerConfig,
    )

    setup = tks.build_ks(tks.KS22, device="cpu")
    n_envs = 2
    trainer = BatchedTrainer(setup.env, setup.agent,
                             BatchedTrainerConfig(n_envs=n_envs, batch_size=8),
                             random_init=setup.random_init)
    ts = trainer.init(torch.Generator().manual_seed(0))
    # each step pushes n_envs * n_act rows; learning starts past update_after * n_act
    chunk = trainer.make_chunk_fn(setup.agent.cfg.update_after // n_envs + 1)
    return lambda: chunk(ts), ts.agent.actor.w[0]


def _fluid_local_step():
    """One train step of a tiny fluid trainer (16^2 grid, 2 envs)."""
    import dataclasses

    from distributedconvrl_pde_control_torch.configs import fluid as tfluid
    from distributedconvrl_pde_control_torch.parallel import multichip as tmc

    cfg = dataclasses.replace(tfluid.FLUID_8, nx=16, sensors_per_axis=4, adaptive=False, te=0.3)
    trainer = tmc.ShardedFluidTrainer(
        cfg, (1, 1), tmc.ShardedTrainConfig(n_envs=2, batch_size=8, capacity_per_dp=1000,
                                            y0_pool_size=3), device="cpu")
    st = trainer.init(torch.Generator().manual_seed(0), seed=5)
    return lambda: trainer._local_step(st)


def _spans_traced(tmp_path, fn) -> list:
    """The user annotations (the program's spans) in a trace of `fn()`."""
    with profiling.trace(str(tmp_path / "profile")):
        fn()
    events = json.loads((tmp_path / "profile" / profiling.TRACE_FILE).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and not e["name"].startswith("Optimizer.")]  # torch.optim's own annotations
    assert {e["name"] for e in spans} <= set(profiling.SPANS)
    return spans


def _nested(spans, inner: str, outer: str) -> bool:
    """Every `inner` span lies inside some `outer` span of its thread, and
    there is at least one."""
    outs = [e for e in spans if e["name"] == outer]
    ins = [e for e in spans if e["name"] == inner]
    return bool(ins) and all(
        any(o["tid"] == i["tid"] and o["ts"] <= i["ts"]
            and i["ts"] + i["dur"] <= o["ts"] + o["dur"] for o in outs) for i in ins)


@pytest.mark.parametrize("path", ["control", "train"])
def test_spans_off_never_record(monkeypatch, path):
    """With no profiler recording, neither `span` nor `annotate` enters
    `record_function`: a KS control step and a batched train chunk that
    learns run with it made to raise."""

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    # the port's spans enter it through torch.profiler (torch.optim opens its
    # own through torch.autograd.profiler, unguarded)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    @profiling.annotate("agent.act")
    def work(x):
        with profiling.span("env.solve"):
            return x + 1

    assert work(1) == 2 and work.__name__ == "work"
    if path == "control":
        assert torch.isfinite(_ks_control_step()().y).all()
    else:
        chunk, w0 = _ks_train_chunk()
        before = w0.detach().clone()
        chunk()
        assert not torch.equal(w0, before)  # the learner ran


def test_control_step_spans(tmp_path):
    """Under `profiling.trace` a KS control step shows `agent.act`,
    `env.step` and `env.solve`, the solve nested in the step."""
    spans = _spans_traced(tmp_path, _ks_control_step())
    assert {e["name"] for e in spans} == {"agent.act", "env.step", "env.solve"}
    assert _nested(spans, "env.solve", "env.step")


def test_train_step_spans(tmp_path):
    """A batched KS train chunk past `update_after` shows `replay.sample` and
    `agent.learn` beside the act and env spans."""
    chunk, _ = _ks_train_chunk()
    spans = _spans_traced(tmp_path, chunk)
    assert {e["name"] for e in spans} == set(profiling.SPANS)
    assert _nested(spans, "env.solve", "env.step")


def test_fluid_local_step_spans(tmp_path):
    """The fluid trainer's inline env block is `env.step`, its solver
    dispatch `env.solve` inside it."""
    spans = _spans_traced(tmp_path, _fluid_local_step())
    assert {"agent.act", "env.step", "env.solve"} <= {e["name"] for e in spans}
    assert _nested(spans, "env.solve", "env.step")


def test_span_table_is_complete():
    """Every name in `SPANS` is opened somewhere in the port, and every span
    the port opens (`span("...")` or `annotate("...")`) is in `SPANS`."""
    import ast

    opened = set()
    for path in (ROOT / "distributedconvrl_pde_control_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) in ("span", "annotate")
                    and node.args and isinstance(node.args[0], ast.Constant)):
                opened.add(node.args[0].value)
    assert opened == set(profiling.SPANS)
