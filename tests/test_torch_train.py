"""Parity of the port's training path with the JAX reference: `Model.loss`
and its gradients, activation checkpointing, microbatched accumulation, the
train step on every config, training end to end, and the routing of
experts by `n_experts` in any family.

The reference's tree (its structure traced, its values seeded numpy) goes
into both packages, carried into the port by `convert.params_from_jax`.

Tolerances. The loss is held to 1e-3 of its value and each gradient leaf
to 5e-2 of its largest magnitude (GRAD_SHARE): the gradients are bf16 for
bf16 leaves, one bf16 ulp is 2^-8 = 3.9e-3 of a value, and in this process
XLA keeps fused chains of bf16 ops in f32 (`xla_allow_excess_precision`)
where the port rounds every op, so activations part by an ulp here and
there and their differences add up over the backward pass (the worst seen
is 2.3e-2, a mamba skip weight). Within the port, `remat` recomputes the
same ops on the same values, so its gradients are bitwise; two microbatches
sum bf16 gradients of the halves in f32, so they are held to 1e-2 of each
leaf's largest magnitude and the loss to 1e-6. The 10 steps of the same
run in both packages (in a process where XLA rounds every bf16 op,
tests/torch_parity.py) track to 1e-3 of the loss at every step. The MoE
aux loss is a mean summed in another order: 1e-6 of its value where both
packages route the same activations (the exact-rounding process), 1e-4
in this process, where the router's inputs part by those bf16 ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.formats import get_spec as jget_spec
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models.model import Model as JModel
from repro.optim.optimizers import AdamW as JAdamW
from repro.serve.engine import GenerationEngine as JEngine
from repro.train.trainer import make_train_step as jmake_train_step

from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import AdamW
from repro_torch.serve.engine import GenerationEngine
from repro_torch.train.trainer import build_optimizer, device_batch, make_train_step
from test_torch_optim import _reference_tree, one_thread  # noqa: F401 (an autouse fixture)
from torch_parity import Exact

GRAD_ARCHS = ("llama3.2-1b", "grok-1-314b", "falcon-mamba-7b", "hubert-xlarge")
LOSS_RTOL = 1e-3
GRAD_SHARE = 5e-2
MICRO_SHARE = 1e-2
AUX_TOL = 1e-6
AUX_RTOL = 1e-4  # this process: the router's inputs differ by bf16 ulps
SHAPE = ("t", "train", 16, 2)
# the FFN routes by n_experts alone: experts in a dense family, none in an MoE one
EXPERT_CASES = {
    "dense_with_experts": ("llama3.2-1b", {"n_experts": 4, "experts_per_token": 2}),
    "moe_without_experts": ("grok-1-314b", {"n_experts": 0}),
}
ENGINE = dict(max_len=64, block_size=8, max_slots=3, num_blocks=12, decode_chunk=4)
LENGTHS = (5, 17, 9)
NEW = 5  # the prefill's token, then one decode chunk of 4
TRACK_STEPS = 10


def _configs(case):
    arch, change = EXPERT_CASES[case]
    return (dataclasses.replace(jget_smoke_config(arch), **change),
            dataclasses.replace(get_smoke_config(arch), **change))


def _case_tree(case):
    """The reference's tree for an EXPERT_CASES config, seeded numpy."""
    jcfg, _ = _configs(case)
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.02).astype(p.dtype), shapes)


def _batch(cfg, seed=3, step=0):
    return SyntheticPipeline(cfg, ShapeConfig(*SHAPE), seed=seed).batch(step)


def expert_route_report(cases, track):
    """Run in the exact-rounding process. For each of `cases` (names of
    EXPERT_CASES): the reference's loss terms on a pipeline batch, and both
    paged engines' greedy tokens and stats on the tree compressed to
    bf8_50. With `track`, also TRACK_STEPS AdamW steps of llama3.2-1b
    smoke in both packages from one tree: both loss trajectories."""
    torch.set_num_threads(1)
    out = {}
    for case in cases:
        jcfg, tcfg = _configs(case)
        tree = _case_tree(case)
        jbatch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
        _, met = jax.jit(lambda p, b: JModel(jcfg).loss(p, b, remat=False))(tree, jbatch)
        jtree = jcompress_tree(tree, jget_spec("bf8_50"))
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in LENGTHS]
        runs = []
        for eng in (JEngine(JModel(jcfg), jtree, paged=True, kv_quant="none", **ENGINE),
                    GenerationEngine(Model(tcfg), params_from_jax(jax.device_get(jtree), tcfg,
                                                                   device="cpu"),
                                     kv_quant="none", device="cpu", **ENGINE)):
            rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
            done = eng.run_until_drained()
            st = eng.scheduler.stats()
            runs.append(([np.asarray(done[r]).tolist() for r in rids],
                         {k: st[k] for k in ("prefill_calls", "decode_steps")}))
        out[case] = {"loss": {k: float(v) for k, v in met.items()},
                     "ref": runs[0], "port": runs[1]}
    if track:
        out["track"] = _track_both()
    return out


def _track_both():
    """TRACK_STEPS steps of llama3.2-1b smoke, AdamW at lr 3e-3, no remat,
    in both packages from one tree: ([reference losses], [port losses])."""
    jcfg, tcfg = jget_smoke_config("llama3.2-1b"), get_smoke_config("llama3.2-1b")
    tree = _reference_tree("llama3.2-1b")
    jpipe = JPipeline(jcfg, JShapeConfig("t", "train", 32, 8), seed=9)
    jopt = JAdamW(lr=3e-3, weight_decay=0.0)
    jstep = jax.jit(jmake_train_step(JModel(jcfg), jopt, remat=False))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    model = Model(tcfg)
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    tp = params_from_jax(tree, tcfg, device="cpu")
    ts = opt.init(tp)
    step = make_train_step(model, opt, remat=False)
    pipe = SyntheticPipeline(tcfg, ShapeConfig("t", "train", 32, 8), seed=9)
    ref, mine = [], []
    for i in range(TRACK_STEPS):
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in jpipe.batch(i).items()}, i)
        ref.append(float(m["loss"]))
        tp, ts, m = step(tp, ts, device_batch(pipe.batch(i), "cpu"), i)
        mine.append(float(m["loss"]))
    return ref, mine


class _Reports:
    """Two exact-rounding processes, one an EXPERT_CASES config, the second
    also tracking the 10 steps, started together."""

    def __init__(self):
        a, b = sorted(EXPERT_CASES)
        self.procs = [Exact("test_torch_train", "expert_route_report", [a], False),
                      Exact("test_torch_train", "expert_route_report", [b], True)]

    def result(self):
        out = {}
        for p in self.procs:
            out.update(p.result())
        return out


@pytest.fixture(scope="module")
def exact():
    """The exact-rounding processes, started when the file's first test
    starts, so they run beside the in-process tests."""
    return _Reports()


# ---------------------------------------------------------------------------
# loss and gradients against the reference
# ---------------------------------------------------------------------------

class _Recorder:
    """An optimizer that keeps the grads it is handed and moves nothing."""

    def update(self, grads, state, params, step):
        self.grads = flatten(grads)
        return params, state


def _port_grads(model, params, batch, remat):
    """(loss, {ce, aux, z_loss}, flat grads) of the port's train step."""
    rec = _Recorder()
    _, _, m = make_train_step(model, rec, remat=remat)(params, None, batch, 0)
    return float(m["loss"]), {k: float(m[k]) for k in ("ce", "aux", "z_loss")}, rec.grads


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_reference(exact, arch):
    """`Model.loss` with remat and its gradients against
    `jax.value_and_grad(model.loss)`: llama3.2-1b (dense, tied head),
    grok-1-314b (MoE: the aux term live), falcon-mamba-7b (the scan) and
    hubert-xlarge (a bidirectional encoder fed `embeds`, labels that are
    the tokens themselves)."""
    jcfg, cfg = jget_smoke_config(arch), get_smoke_config(arch)
    tree = _reference_tree(arch)
    batch = _batch(cfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: JModel(jcfg).loss(p, b, remat=True),
                                    has_aux=True))
    (jloss, jmet), jgrads = fn(jax.tree.map(jnp.asarray, tree),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    want = flatten(params_from_jax(jax.device_get(jgrads), cfg, device="cpu"))
    loss, met, got = _port_grads(Model(cfg), params_from_jax(tree, cfg, device="cpu"),
                                 device_batch(batch, "cpu"), remat=True)
    assert loss == pytest.approx(float(jloss), rel=LOSS_RTOL)
    for k in ("ce", "z_loss"):
        assert met[k] == pytest.approx(float(jmet[k]), rel=LOSS_RTOL), k
    assert (met["aux"] > 0) == bool(cfg.n_experts)
    assert met["aux"] == pytest.approx(float(jmet["aux"]), rel=AUX_RTOL)
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        assert got[name].dtype == g.dtype, name
        scale = float(g.float().abs().max())
        err = float((got[name].float() - g.float()).abs().max())
        assert err <= GRAD_SHARE * scale, (name, err, scale)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_remat_equals_no_remat_bitwise(arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = params_from_jax(_reference_tree(arch), cfg, device="cpu")
    batch = device_batch(_batch(cfg), "cpu")
    a = _port_grads(model, params, batch, remat=True)
    b = _port_grads(model, params, batch, remat=False)
    assert a[0] == b[0] and a[1] == b[1]
    for name in a[2]:
        assert torch.equal(a[2][name], b[2][name]), name


def test_two_microbatches_equal_one_batch():
    cfg = get_smoke_config("llama3.2-1b")
    model = Model(cfg)
    params = params_from_jax(_reference_tree("llama3.2-1b"), cfg, device="cpu")
    batch = device_batch(SyntheticPipeline(cfg, ShapeConfig("t", "train", 16, 4), seed=2).batch(0),
                         "cpu")
    runs = []
    for n in (1, 2):
        rec = _Recorder()
        _, _, metrics = make_train_step(model, rec, n_microbatches=n)(params, None, batch, 0)
        runs.append((rec.grads, metrics))
    (one, m1), (two, m2) = runs
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m2["ce"]) == float(m2["loss"]) and float(m2["aux"]) == 0.0
    for name, g in one.items():
        assert two[name].dtype == torch.float32
        scale = float(g.float().abs().max())
        assert float((two[name] - g.float()).abs().max()) <= MICRO_SHARE * scale, name


def test_microbatches_cut_mrope_positions_on_their_batch_axis():
    cfg = get_smoke_config("qwen2-vl-7b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = device_batch(SyntheticPipeline(cfg, ShapeConfig("t", "train", 8, 4)).batch(0), "cpu")
    _, _, m = make_train_step(model, _Recorder(), n_microbatches=2)(params, None, batch, 0)
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_loss_decreases_end_to_end():
    """The reference's end-to-end check in the port: a tiny llama on the
    synthetic data drops its loss by more than 0.5 in 30 steps (model,
    optimizer, pipeline and step together)."""
    cfg = get_smoke_config("llama3.2-1b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    state = opt.init(params)
    pipe = SyntheticPipeline(cfg, ShapeConfig("t", "train", 32, 8), seed=9)
    step_fn = make_train_step(model, opt, remat=False)
    losses = []
    for step in range(30):
        params, state, m = step_fn(params, state, device_batch(pipe.batch(step), "cpu"), step)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


def test_ten_steps_track_reference(exact):
    ref, mine = exact.result()["track"]
    assert len(ref) == len(mine) == TRACK_STEPS
    for i, (a, b) in enumerate(zip(ref, mine)):
        assert b == pytest.approx(a, rel=LOSS_RTOL), (i, ref, mine)
    assert mine[-1] < mine[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_on_every_config(arch):
    """The reference's per-config smoke step in the port: one step of
    `cfg.optimizer` with remat, at step 100, the schedule's peak (its
    warmup lr is 0 at step 0); the loss is finite and the params move."""
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    before = [p.clone() for p in flatten(params).values()]
    opt = build_optimizer(cfg)
    params, _, metrics = make_train_step(model, opt)(
        params, opt.init(params), device_batch(_batch(cfg), "cpu"), 100)
    assert np.isfinite(float(metrics["loss"]))
    assert sum(float((p.float() - b.float()).abs().sum())
               for p, b in zip(flatten(params).values(), before)) > 0.0


# ---------------------------------------------------------------------------
# experts route by n_experts in any family (ROADMAP Queue C)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(EXPERT_CASES))
def test_experts_route_by_n_experts_in_any_family(exact, case):
    """A dense config with experts gets the MoE FFN and an MoE config
    without them the dense MLP, as in the reference: the tree's leaves, the
    loss terms, and the paged engine's greedy tokens and stats (in the
    exact-rounding process) are the reference's."""
    jcfg, tcfg = _configs(case)
    tree = _case_tree(case)
    params = params_from_jax(tree, tcfg, device="cpu")
    ffn = "moe" if tcfg.n_experts else "mlp"
    assert all(ffn in layer for layer in params["layers"])
    assert {k: tuple(v.shape) for k, v in flatten(params).items()} == {
        k: tuple(v.shape) for k, v in flatten(Model(tcfg).init(
            torch.Generator().manual_seed(0), device="cpu")).items()}
    _, met, _ = _port_grads(Model(tcfg), params, device_batch(_batch(tcfg), "cpu"), remat=False)
    rep = exact.result()[case]
    for k in ("ce", "z_loss"):
        assert met[k] == pytest.approx(rep["loss"][k], rel=LOSS_RTOL), k
    assert met["aux"] == pytest.approx(rep["loss"]["aux"], rel=AUX_TOL)
    assert (met["aux"] > 0) == bool(tcfg.n_experts)
    assert rep["port"] == rep["ref"]


@pytest.mark.parametrize("k", [0, 5])
def test_experts_per_token_outside_one_to_n_experts_is_refused(k):
    """The one refusal left: the reference's top-k fails at k > E and its
    aux loss is NaN at k = 0."""
    cfg = dataclasses.replace(get_smoke_config("grok-1-314b"), experts_per_token=k)
    with pytest.raises(ValueError, match="experts_per_token"):
        Model(cfg)

