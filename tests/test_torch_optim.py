"""Parity of the port's training substrate with the JAX reference: the run
shapes, the synthetic pipeline, the schedule, AdamW and Adafactor, the
train-state `Checkpointer`, checkpoint-restart training, and the port's
twin of `examples/train_small_lm.py`.

Tolerances. The pipeline, `SHAPES` and `is_encoder` are bitwise the
reference's. AdamW is bitwise while the global-norm clip leaves the grads
alone (its scale is then exactly 1): its ops are f32 multiplies, adds,
divisions and square roots, each rounded once in both packages, and its
`pow` of the bias corrections agrees at these steps. With the clip live,
the global norm sums in another order (XLA's reduction against torch's),
so the master weights are held to 1e-6 of their largest magnitude.
Adafactor's row and column means sum in another order too: its f32 state
is held to 1e-5 of the largest magnitude of each factor, and its bf16
params to one bf16 ulp (2^-8 of the largest magnitude), since an f32
value an ulp apart can round to the neighbouring bf16 value. The schedule
is equal at most steps and up to 2 ulps apart where XLA's f32 `cos` and
torch's differ by one. For the bitwise check the reference's optimizer runs
eagerly (op by op), where XLA contracts no multiply-add into an FMA; the
checks held to a tolerance jit it.

The checkpoint-restart check is the reference's: a crash at step 6, after
the step-4 checkpoint, resumed, ends bit-identical to the uninterrupted
run. A checkpoint the reference writes restores through the port's reader
and `convert.params_from_jax` / `opt_state_from_jax` to the same values.
"""
import dataclasses
import functools
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as JCheckpointer
from repro.configs.base import ARCH_IDS
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models.model import Model as JModel
from repro.optim import optimizers as jopt

from repro_torch.checkpoint.ckpt import Checkpointer, flatten, nest
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config, get_smoke_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.dist.fault import FaultInjector, ResilientTrainer, StragglerWatchdog
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import (AdamW, Adafactor, clip_by_global_norm, global_norm,
                                          make_optimizer, tree_map, warmup_cosine)
from repro_torch.train.trainer import build_optimizer, make_train_step, train_loop
from test_torch_imports import _forbidden, _imported_modules

STEPS = 20
MASTER_TOL = 1e-6   # AdamW's f32 master with the clip live, of its largest magnitude
STATE_TOL = 1e-5    # Adafactor's f32 factors, of their largest magnitude
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke shapes gain nothing from torch's intra-op threads, and beside
    the other test workers (and any exact-rounding process) more threads
    only spin against each other: one thread while the module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _share(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |a|."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(a.abs().max()), 1e-30))


# ---------------------------------------------------------------------------
# shapes and the pipeline
# ---------------------------------------------------------------------------

def test_shapes_and_is_encoder_are_the_references():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    for arch in ARCH_IDS:
        assert get_smoke_config(arch).is_encoder == jget_smoke_config(arch).is_encoder


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pipeline_batches_are_the_references_bitwise(arch):
    """Labels (masked-prediction targets for the encoder), tokens or the
    stubbed frontends' embeddings, M-RoPE positions and the mask, at three
    steps and on two hosts."""
    shape = ShapeConfig("t", "train", 12, 4)
    for n_hosts, host in ((1, 0), (2, 1)):
        mine = SyntheticPipeline(get_smoke_config(arch), shape, seed=7, n_hosts=n_hosts,
                                 host_id=host)
        ref = JPipeline(jget_smoke_config(arch), JShapeConfig("t", "train", 12, 4), seed=7,
                        n_hosts=n_hosts, host_id=host)
        for step in (0, 3, 11):
            a, b = mine.batch(step), ref.batch(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                assert a[k].tobytes() == b[k].tobytes(), (arch, k)


def test_pipeline_determinism_and_host_sharding():
    cfg = get_smoke_config("llama3-8b")
    shape = ShapeConfig("t", "train", 8, 4)
    a = SyntheticPipeline(cfg, shape, seed=1).batch(3)
    assert np.array_equal(a["tokens"], SyntheticPipeline(cfg, shape, seed=1).batch(3)["tokens"])
    assert not np.array_equal(a["tokens"], SyntheticPipeline(cfg, shape, seed=1).batch(4)["tokens"])
    h0 = SyntheticPipeline(cfg, shape, seed=1, n_hosts=2, host_id=0).batch(3)
    h1 = SyntheticPipeline(cfg, shape, seed=1, n_hosts=2, host_id=1).batch(3)
    assert h0["tokens"].shape == (2, 8)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError, match="divide"):
        SyntheticPipeline(cfg, ShapeConfig("t", "train", 8, 3), n_hosts=2)


# ---------------------------------------------------------------------------
# the schedule and the optimizers
# ---------------------------------------------------------------------------

def test_warmup_cosine_tracks_reference_and_its_shape():
    kw = dict(peak_lr=1e-3, warmup=10, total=60)
    mine = np.array([float(warmup_cosine(s, **kw)) for s in range(80)], np.float32)
    ref = np.array([float(jopt.warmup_cosine(s, **kw)) for s in range(80)], np.float32)
    ulps = np.abs(mine.view(np.int32) - ref.view(np.int32))
    assert ulps[:11].max() == 0  # the warmup: multiplies and a division
    # f32 cos differs by 1 ulp at 4 of these 80 angles; 1 + cos near -1
    # doubles it in the schedule
    assert ulps.max() <= 2 and (ulps == 0).mean() > 0.9, ulps
    # the reference's schedule test
    assert float(warmup_cosine(0, peak_lr=1.0, warmup=10)) == 0.0
    assert float(warmup_cosine(10, peak_lr=1.0, warmup=10)) == pytest.approx(1.0)
    assert float(warmup_cosine(10_000, peak_lr=1.0, warmup=10)) <= 0.11


def _quad(opt):
    """The reference's convergence check: minimize ||p - target||^2."""
    target = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32))
    params = {"w": torch.zeros((8, 16)), "layers": []}
    state = opt.init(params)
    for step in range(300):
        grads = {"w": 2 * (params["w"] - target), "layers": []}
        params, state = opt.update(grads, state, params, step)
    return float((params["w"] - target).abs().mean())


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_converges(name):
    kw = {"weight_decay": 0.0} if name == "adamw" else {}
    assert _quad(make_optimizer(name, lr=0.05, **kw)) < 0.05


def test_adafactor_state_is_factored():
    st = Adafactor().init({"w": torch.zeros((64, 128), dtype=torch.bfloat16), "layers": []})
    assert sum(t.numel() for t in flatten(st).values()) == 64 + 128  # vr + vc
    # a stacked norm (n_layers, d) is factored, as the reference's stack is
    layers = [{"n": torch.zeros(32), "w": torch.zeros((16, 8))} for _ in range(4)]
    st = Adafactor(stacked=True).init({"layers": layers})
    assert {k: tuple(v.shape) for k, v in flatten(st).items()} == {
        "v/layers/n/vr": (4,), "v/layers/n/vc": (32,),
        "v/layers/w/vr": (4, 16), "v/layers/w/vc": (4, 8)}


def _random_grads(jparams, seed, scale=0.01):
    """Seeded numpy values shaped and typed as the reference's params."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(p.dtype),
                        jparams)


def _reference_tree(arch, seed=100):
    """A params tree of the reference's structure for `arch`'s smoke
    config (its uniform stack as `blocks`), seeded numpy values: the
    shapes are traced, not computed, which spares the reference's init its
    compiles."""
    shapes = jax.eval_shape(JModel(jget_smoke_config(arch)).init, jax.random.PRNGKey(0))
    return _random_grads(shapes, seed, scale=0.02)


def _run_both(arch, jo, to, steps=STEPS, eager=False):
    """`steps` updates of the reference's optimizer `jo` (jitted, or op by
    op with `eager`) and the port's `to` on one smoke tree from the same
    grads; returns (reference params, reference state, port params, port
    state)."""
    cfg = get_smoke_config(arch)
    jp = jax.tree.map(jnp.asarray, _reference_tree(arch))
    tp = params_from_jax(jax.device_get(jp), cfg, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    update = jo.update if eager else jax.jit(jo.update)
    for step in range(steps):
        g = _random_grads(jp, step)
        jp, js = update(jax.tree.map(jnp.asarray, g), js, jp, step)
        tp, ts = to.update(params_from_jax(g, cfg, device="cpu"), ts, tp, step)
    return jax.device_get(jp), jax.device_get(js), tp, ts


def _lr(schedule):
    """The schedule both packages' optimizers run in these tests."""
    return functools.partial(schedule, peak_lr=1e-2, warmup=5, total=STEPS)


def test_adamw_is_the_references_bitwise_while_the_clip_is_idle():
    """llama3.2-1b smoke, 20 steps at a constant lr (the schedule's cos is
    an ulp apart at some steps, above): mu, nu, the f32 master and the bf16
    params are the reference's, bit for bit."""
    ref_p, ref_s, p, s = _run_both("llama3.2-1b", jopt.AdamW(lr=1e-2, max_grad_norm=1e9),
                                   AdamW(lr=1e-2, max_grad_norm=1e9), eager=True)
    cfg = get_smoke_config("llama3.2-1b")
    want = opt_state_from_jax(ref_s, cfg, device="cpu")
    for k in ("mu", "nu", "master"):
        for name, leaf in flatten(want[k]).items():
            assert torch.equal(flatten(s[k])[name], leaf), (k, name)
    for name, leaf in flatten(params_from_jax(ref_p, cfg, device="cpu")).items():
        got = flatten(p)[name]
        assert got.dtype == leaf.dtype and torch.equal(got, leaf), name


def test_adamw_with_a_live_clip_tracks_reference():
    """The reference's defaults (clip at global norm 1): the grads' norm is
    ~0.6-1.8 here, so some steps clip; the norm's summation order puts the
    master within MASTER_TOL."""
    g = _random_grads(_reference_tree("gemma2-2b"), 0)
    cfg = get_smoke_config("gemma2-2b")
    norm = float(global_norm(params_from_jax(g, cfg, device="cpu")))
    assert norm == pytest.approx(float(jopt.global_norm(g)), rel=1e-5)
    ref_p, ref_s, p, s = _run_both("gemma2-2b", jopt.AdamW(lr=1e-2), AdamW(lr=1e-2))
    want = opt_state_from_jax(ref_s, cfg, device="cpu")
    for name, leaf in flatten(want["master"]).items():
        assert _share(leaf, flatten(s["master"])[name]) < MASTER_TOL, name


def test_clip_by_global_norm_scales_to_the_bound():
    grads = {"a": torch.full((4,), 3.0), "layers": [{"b": torch.full((2, 2), 4.0)}]}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b"])
def test_adafactor_tracks_reference(arch):
    """llama3.2-1b is a uniform stack: the port runs each layer leaf on the
    reference's (n_layers, ...) view, factoring the stacked norms and
    clipping by one RMS over all layers (`Adafactor(stacked=True)`, as
    `build_optimizer` sets it). gemma2-2b alternates local and global
    layers, so the reference keeps its layers apart and so does the port."""
    cfg = get_smoke_config(arch)
    stacked = Model(cfg).layer_stack > 1
    assert stacked == (arch == "llama3.2-1b")
    ref_p, ref_s, p, s = _run_both(arch, jopt.Adafactor(lr=_lr(jopt.warmup_cosine)),
                                   Adafactor(lr=_lr(warmup_cosine), stacked=stacked))
    want = flatten(opt_state_from_jax(ref_s, cfg, device="cpu"))
    got = flatten(s)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert got[name].shape == leaf.shape and _share(leaf, got[name]) < STATE_TOL, name
    for name, leaf in flatten(params_from_jax(ref_p, cfg, device="cpu")).items():
        assert _share(leaf, flatten(p)[name]) <= BF16_ULP, name


def test_build_optimizer_follows_the_config():
    assert isinstance(build_optimizer(get_smoke_config("llama3.2-1b")), AdamW)
    kimi = build_optimizer(get_config("kimi-k2-1t-a32b"))
    assert isinstance(kimi, Adafactor) and kimi.stacked
    assert float(kimi.lr(100)) == pytest.approx(3e-4)
    with pytest.raises(ValueError):
        make_optimizer("sgd")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "layers": [{"b": torch.randn(4).to(torch.bfloat16)}]}
    opt = {"mu": tree_map(torch.zeros_like, params)}
    ck.save(7, params, opt)
    step, tree = ck.restore({"params": params, "opt_state": opt})
    assert step == 7
    for k, v in flatten({"params": params, "opt_state": opt}).items():
        got = flatten(tree)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    for s in (8, 9, 10, 11):
        ck.save(s, params, opt)
    assert ck.all_steps() == [9, 10, 11]


def test_incomplete_checkpoint_is_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(5, {"a": torch.ones(2), "layers": []})
    os.makedirs(tmp_path / "step_00000009" / "host0000")  # a crash mid-save
    os.makedirs(tmp_path / "step_00000010.tmp")
    assert ck.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"params": {}})


def test_async_save_copies_before_the_next_in_place_update(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    params = {"a": torch.zeros(1 << 16), "layers": []}
    ck.save(1, params)
    params["a"].add_(1.0)  # the optimizer's next in-place step
    ck.wait()
    _, flat = ck.read(1)
    assert not flat["params/a"].any()


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference's Checkpointer writes llama3.2-1b's smoke params and
    AdamW state (after one step) and gemma2-2b's Adafactor state; the
    port's reader, `nest` and the converters give the same values."""
    for arch, jo in (("llama3.2-1b", jopt.AdamW()), ("gemma2-2b", jopt.Adafactor())):
        cfg = get_smoke_config(arch)
        jp = jax.tree.map(jnp.asarray, _reference_tree(arch, seed=1))
        js = jo.init(jp)
        jp, js = jax.jit(jo.update)(jax.tree.map(jnp.asarray, _random_grads(jp, 0)), js, jp, 0)
        JCheckpointer(str(tmp_path / arch), async_save=False).save(3, jp, js)
        step, flat = Checkpointer(str(tmp_path / arch)).read()
        tree = nest(flat)
        assert step == 3
        want = {"params": params_from_jax(jax.device_get(jp), cfg, device="cpu"),
                "opt_state": opt_state_from_jax(jax.device_get(js), cfg, device="cpu")}
        got = {"params": params_from_jax(tree["params"], cfg, device="cpu"),
               "opt_state": opt_state_from_jax(tree["opt_state"], cfg, device="cpu")}
        fw, fg = flatten(want), flatten(got)
        assert sorted(fw) == sorted(fg)
        for k in fw:
            assert fg[k].dtype == fw[k].dtype and torch.equal(fg[k], fw[k]), (arch, k)


def test_port_checkpoint_writes_the_references_layout(tmp_path):
    """The port's step directory holds host0000/shards.npz and a manifest of
    leaves, bf16 stored as uint16 words, which the reference restores."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    params = {"embed": torch.randn(4, 3).to(torch.bfloat16), "layers": [{"w": torch.ones(2)}]}
    ck.save(12, params)
    d = tmp_path / "step_00000012"
    assert sorted(os.listdir(d)) == ["host0000", "manifest.json"]
    assert os.listdir(d / "host0000") == ["shards.npz"]
    like = {"params": {"embed": np.zeros((4, 3)), "layers": [{"w": np.zeros(2)}]}}
    step, tree = JCheckpointer(str(tmp_path)).restore(like)
    assert step == 12 and str(tree["params"]["embed"].dtype) == "bfloat16"
    assert np.asarray(tree["params"]["embed"]).astype(np.float32).tobytes() == \
        params["embed"].float().numpy().tobytes()


# ---------------------------------------------------------------------------
# checkpoint-restart training and the loop's hooks
# ---------------------------------------------------------------------------

def _restart_run(root, injector=None):
    cfg = get_smoke_config("llama3.2-1b")
    model = Model(cfg)
    pipeline = SyntheticPipeline(cfg, ShapeConfig("t", "train", 8, 4), seed=5)
    opt = build_optimizer(cfg)

    def init_fn():
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        return params, opt.init(params)

    tr = ResilientTrainer(model, lambda: make_train_step(model, opt, remat=False), pipeline,
                          Checkpointer(str(root), async_save=False), checkpoint_every=4,
                          injector=injector, watchdog=StragglerWatchdog())
    params, opt_state = tr.run(init_fn, 10)
    return tr, params, opt_state


def test_fault_restart_bit_identical(tmp_path):
    """A crash at step 6, after the step-4 checkpoint, restarts from step 4
    and ends with params and optimizer state bit-identical to the
    uninterrupted run, and the same history."""
    ref, ref_params, ref_state = _restart_run(tmp_path / "ref")
    tr, params, state = _restart_run(tmp_path / "ft", FaultInjector(plan={6: "crash"}))
    assert ref.restarts == 0 and tr.restarts == 1
    want, got = flatten({"p": ref_params, "s": ref_state}), flatten({"p": params, "s": state})
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert [s for s, _ in tr.history] == list(range(10))
    assert tr.history == ref.history


def test_straggler_watchdog():
    w = StragglerWatchdog(factor=3.0)
    for i in range(8):
        w.observe(i, 0.01)
    assert w.observe(8, 0.2) is True
    assert w.events == [8]


def test_train_loop_flags_stragglers_checkpoints_and_refuses_distribution(tmp_path):
    cfg = get_smoke_config("llama3.2-1b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW()
    pipe = SyntheticPipeline(cfg, ShapeConfig("t", "train", 8, 2), seed=1)
    seen = []
    ck = Checkpointer(str(tmp_path), async_save=False)
    params, _, hist = train_loop(model, params, opt.init(params), pipe, n_steps=3,
                                 train_step=make_train_step(model, opt, remat=False),
                                 checkpointer=ck, checkpoint_every=2, step_timeout_s=1e-9,
                                 on_step=lambda s, m: seen.append(s))
    assert seen == [0, 1, 2] and all(m["straggler"] for _, m, _ in hist)
    assert ck.all_steps() == [2]
    # the reference's contract: compression needs the mesh that carries it
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(model, grad_compression="int8")
    with pytest.raises(ValueError, match="mesh"):
        train_loop(model, params, None, pipe, n_steps=1, grad_compression="int8")
    # a mesh without compression is accepted: on a one-rank world the loop
    # is the plain one, bitwise
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh(1, 1, device="cpu")
        runs = []
        for kw in ({}, {"mesh": mesh}):
            p0 = model.init(torch.Generator().manual_seed(0), device="cpu")
            runs.append(train_loop(model, p0, opt.init(p0), pipe, n_steps=1,
                                   train_step=make_train_step(model, opt, remat=False, **kw),
                                   **kw))
    finally:
        dist.destroy_process_group()
    (a, _, ha), (b, _, hb) = runs
    assert ha[0][1] == hb[0][1]
    assert not torch.equal(a["embed"], model.init(torch.Generator().manual_seed(0),
                                                  device="cpu")["embed"])
    assert all(torch.equal(x, y) for x, y in zip(flatten(a).values(), flatten(b).values()))


# ---------------------------------------------------------------------------
# the port's twin of examples/train_small_lm.py
# ---------------------------------------------------------------------------

def test_train_small_lm_twin_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """Three steps of the 10m preset with a checkpoint at step 2, then a
    second run of four steps that resumes from it."""
    path = Path(__file__).resolve().parents[1] / "examples" / "train_small_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_small_lm_torch", path)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    common = ["--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
              "--ckpt-dir", str(tmp_path)]
    twin.main(common + ["--steps", "3"])
    first = capsys.readouterr().out
    assert "on cpu" in first and "step    2  loss" in first and "resumed" not in first
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    twin.main(common + ["--steps", "4"])
    second = capsys.readouterr().out
    assert "resumed from step 2" in second and "step    3  loss" in second
    losses = [float(line.split("loss")[1].split()[0]) for line in (first + second).splitlines()
              if line.startswith("step ")]
    assert losses and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]


@pytest.mark.parametrize("rel", ["examples/train_small_lm_torch.py", "tools/train_run.py"])
def test_training_entry_points_import_no_jax_and_no_reference(rel):
    path = Path(__file__).resolve().parents[1] / rel
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []
