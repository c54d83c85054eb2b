"""The port's keyed temperature sampler against jax 0.9's.

`serve/sampling.py` rebuilds the reference's `sample_rows_keyed`
(`fold_in(fold_in(PRNGKey(seed), rid), step)`, then
`jax.random.categorical(key, logits / temp)`) from torch integer ops. The
same inputs, made from a seed with numpy, go through both. Threefry, the
key derivation, the random bits and the f32 uniform are bitwise. The
gumbel noise is not: each log is its library's own (XLA:CPU's polynomial,
torch's), each within 1 ulp, and through -log(-log(u)) the inner log's
error becomes an absolute one in the outer, so the two agree to 2 ulp at
the scale max(|g|, 1). A sampled token may therefore differ only at a near
tie: where the reference's top perturbed score and the port's pick lie
within the two scores' tolerance of each other, which the tests check
wherever tokens differ.

Engines: at the smoke config, in a process where XLA rounds every bf16 op
(tests/torch_parity.py) and logits agree bitwise, the port's engine gives
the reference engine's tokens up to a request's first near tie. Within the
port, chunked decode, batch composition and speculation never change a
request's tokens under temperature.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.formats import get_spec as jget_spec
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.engine import sample_rows_keyed as jsample_rows_keyed

from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve import sampling
from repro_torch.serve.engine import GenerationEngine, SpecConfig
from torch_parity import run_exact

SEEDS = (0, 1, 2**32 - 1)
TINY = np.finfo(np.float32).tiny
ENGINE = dict(max_len=64, block_size=8, max_slots=3, num_blocks=10, decode_chunk=4)
LENGTHS = (4, 19, 11, 26, 7)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


def _t(a) -> torch.Tensor:
    """uint32 words as the port holds them: int64."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _ulps(a, b, scale) -> float:
    return float(np.max(np.abs(a.astype(np.float64) - b) / np.spacing(scale)))


def test_threefry2x32_is_bitwise_jax():
    rng = np.random.default_rng(0)
    for _ in range(8):
        key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        count = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
        # jax splits an even count into halves (x0, x1) and concatenates
        y0, y1 = sampling.threefry2x32(_t(key[0]), _t(key[1]), _t(count[:2048]),
                                       _t(count[2048:]))
        got = np.concatenate([y0.numpy(), y1.numpy()]).astype(np.uint32)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_are_bitwise_jax(seed):
    """Keys of seeds 0, 1 and 2^32 - 1, folded with request ids (-1 as
    uint32 too) and every output index from 0 to 2^16."""
    jkey = jax.random.PRNGKey(seed)
    tkey = sampling.prng_key(seed)
    assert np.array_equal(tkey.numpy().astype(np.uint32), np.asarray(jax.random.key_data(jkey)))
    steps = np.arange(2**16 + 1, dtype=np.uint32)
    fold = jax.jit(jax.vmap(lambda k, d: jax.random.key_data(jax.random.fold_in(k, d)),
                            in_axes=(None, 0)))
    for rid in (0, 1, 7, 2**31, 2**32 - 1):
        jr = jax.random.fold_in(jkey, np.uint32(rid))
        tr = sampling.fold_in(tkey, torch.tensor(rid))
        assert np.array_equal(_u32(tr.numpy()), np.asarray(jax.random.key_data(jr)))
        want = np.asarray(fold(jr, jnp.asarray(steps)))
        got = sampling.fold_in(tr.expand(len(steps), 2), _t(steps)).numpy()
        assert np.array_equal(_u32(got), want), rid
    # the padding rows' id: -1 wraps to 0xFFFFFFFF as jnp.asarray(-1, uint32)
    minus = sampling.fold_in(tkey, torch.tensor(-1))
    assert torch.equal(minus, sampling.fold_in(tkey, torch.tensor(2**32 - 1)))


@pytest.mark.parametrize("shape", [(1,), (4, 257), (4, 128256)])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_are_bitwise_jax(seed, shape):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(3))
    tkey = sampling.fold_in(sampling.prng_key(seed), torch.tensor(3))
    n = int(np.prod(shape))
    bits = sampling.random_bits(tkey, n).numpy().reshape(shape)
    assert np.array_equal(_u32(bits), np.asarray(jax.random.bits(jkey, shape)))
    uni = sampling.uniform(tkey, n).numpy().reshape(shape)
    want = np.asarray(jax.random.uniform(jkey, shape, minval=TINY))
    assert uni.dtype == np.float32
    assert np.array_equal(uni.view(np.uint32), want.view(np.uint32))
    assert uni.min() >= TINY and uni.max() < 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulp_of_jax(seed):
    """Not bitwise (see the module docstring): within 2 ulp at the scale
    max(|g|, 1), over half a million draws."""
    jkey = jax.random.PRNGKey(seed)
    tkey = sampling.prng_key(seed)
    n = 4 * 128256
    want = np.asarray(jax.random.gumbel(jkey, (n,), jnp.float32))
    got = sampling.gumbel(tkey, n).numpy()
    assert _ulps(got, want, np.maximum(np.abs(want), 1.0)) <= 2.0


def _tolerance(g: np.ndarray, s: np.ndarray) -> np.ndarray:
    """How far the port's perturbed score can lie from the reference's:
    the gumbel's 2 ulp and one rounding of the sum."""
    return 2 * np.spacing(np.maximum(np.abs(g), 1.0)) + np.spacing(np.abs(s))


def near_tie(logits, temp, key, rid, step, port_tok, ref_tok) -> str:
    """'' when the port's pick `port_tok` is the reference's `ref_tok` or
    the two are a near tie of the reference's perturbed scores of this row;
    else what shows they are not."""
    if port_tok == ref_tok:
        return ""
    k = jax.random.fold_in(jax.random.fold_in(key, np.uint32(rid & 0xFFFFFFFF)),
                           np.uint32(step))
    g = np.asarray(jax.random.gumbel(k, logits.shape, jnp.float32))
    s = np.asarray(jnp.asarray(g) + jnp.asarray(logits, jnp.float32) / jnp.float32(temp))
    tol = _tolerance(g, s)
    gap = float(s[ref_tok]) - float(s[port_tok])
    bound = float(tol[ref_tok] + tol[port_tok])
    if int(np.argmax(s)) != ref_tok or not 0.0 <= gap <= bound:
        return (f"rid {rid} step {step}: port {port_tok}, reference {ref_tok}, score gap "
                f"{gap:.3e} above the tie bound {bound:.3e}")
    return ""


@pytest.mark.parametrize("temp", [0.7, 1.3])
@pytest.mark.parametrize("vocab", [257, 128256])
def test_sample_rows_keyed_matches_reference(vocab, temp):
    """Seeded logits, request ids (a padding row's -1 among them) and
    output indices: the port's tokens are the reference's on every row,
    or a near tie the reference's scores prove."""
    rng = np.random.default_rng(vocab + int(temp * 10))
    n = 16
    logits = (rng.standard_normal((n, vocab)) * 3).astype(np.float32)
    rids = rng.integers(0, 1000, n).astype(np.int64)
    rids[3] = -1
    steps = rng.integers(0, 5000, n).astype(np.int64)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsample_rows_keyed(key, jnp.asarray(rids, jnp.uint32),
                                         jnp.asarray(steps, jnp.uint32),
                                         jnp.asarray(logits), jnp.float32(temp)))
    got = sampling.sample_rows_keyed(sampling.prng_key(11), torch.from_numpy(rids),
                                     torch.from_numpy(steps), torch.from_numpy(logits),
                                     torch.tensor(temp, dtype=torch.float32))
    assert got.dtype == torch.int32 and got.shape == (n,)
    bad = [near_tie(logits[i], temp, key, int(rids[i]), int(steps[i]), int(got[i]),
                    int(want[i])) for i in range(n)]
    assert [b for b in bad if b] == []


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, n).astype(np.int32) for n in LENGTHS]


def _reference_params():
    params = JModel(jget_smoke_config("llama3-8b")).init(jax.random.PRNGKey(0))
    return jcompress_tree(params, jget_spec("bf8_50"))


def _drain(eng, prompts, n_new=6):
    rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    done = eng.run_until_drained()
    return [done[r].tolist() for r in rids]


def temperature_engine_report(kinds, temp, seed):
    """{kind: "ok" or what differed}: the reference and the port engine
    serve the same requests at `temp`; each request's tokens must agree up
    to its first difference, which must be a near tie of the logits the
    port sampled that token from (bitwise the reference's, since every
    earlier token of the request agreed)."""
    jparams = _reference_params()
    tcfg = get_smoke_config("llama3-8b")
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    out = {}
    for kind in kinds:
        jeng = JEngine(JModel(jget_smoke_config("llama3-8b")), jparams, paged=True,
                       kv_quant=kind, temperature=temp, seed=seed, **ENGINE)
        want = _drain(jeng, _prompts())
        seen = {}
        inner = sampling.sample_rows_keyed

        def record(key, rids, steps, logits, t):
            for r, s, row in zip(rids.tolist(), steps.tolist(), logits.float()):
                seen[(r, s)] = row.numpy().copy()
            return inner(key, rids, steps, logits, t)

        sampling.sample_rows_keyed = record
        try:
            teng = GenerationEngine(Model(tcfg), tparams, kv_quant=kind, device="cpu",
                                    temperature=temp, seed=seed, **ENGINE)
            got = _drain(teng, _prompts())
        finally:
            sampling.sample_rows_keyed = inner
        out[kind] = "ok"
        notes = []
        for rid, (a, b) in enumerate(zip(got, want)):
            diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            if len(a) != len(b):
                out[kind] = f"request {rid}: {len(a)} tokens against {len(b)}"
            elif diff:
                step = diff[0]
                why = near_tie(seen[(rid, step)], temp, jax.random.PRNGKey(seed), rid,
                               step, a[step], b[step])
                if why:
                    out[kind] = why
                notes.append(f"request {rid} agrees up to its near tie at output {step}")
        if out[kind] == "ok" and notes:
            out[kind] = "ok: " + "; ".join(notes)
    return out


@pytest.fixture(scope="module")
def temperature_report():
    return run_exact("test_torch_sampling", "temperature_engine_report", ["int8", "nf4"],
                     0.7, 0)


@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_temperature_tokens_match_reference_engine(temperature_report, kind):
    """At T = 0.7, seed 0: the reference engine's tokens for every request,
    up to a near tie that the recorded logits prove."""
    assert temperature_report[kind].startswith("ok"), temperature_report[kind]


def _port_engine(**kw):
    cfg = get_smoke_config("llama3-8b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return GenerationEngine(model, params, device="cpu", **dict(ENGINE, **kw))


@pytest.mark.parametrize("kind", ["none", "int4"])
def test_chunked_equals_single_step_under_temperature(kind):
    """The key of a token is its request and output index, not its chunk:
    decode_chunk=8 and decode_chunk=1 give the same tokens."""
    warm = dict(kv_quant=kind, temperature=0.9, seed=7)
    one = _drain(_port_engine(decode_chunk=1, **warm), _prompts(), 9)
    eight = _drain(_port_engine(decode_chunk=8, **warm), _prompts(), 9)
    assert one == eight
    greedy = _drain(_port_engine(decode_chunk=8, kv_quant=kind), _prompts(), 9)
    assert greedy != eight  # the temperature draws did change the tokens


def test_tokens_do_not_depend_on_the_batch():
    """A request served alone (as request 0) and served behind others
    (as request 3) gets the same tokens only if it keeps its id: the id is
    in its key. Two engines at one seed that give the request the same id
    agree whatever shares its batch."""
    prompts = _prompts()
    warm = dict(temperature=0.8, seed=3)
    crowded = _drain(_port_engine(**warm), prompts, 7)
    eng = _port_engine(**warm)
    # ids 0..3 are taken by requests that finish after one token; request 4
    # then decodes alone
    for p in prompts[:4]:
        eng.submit(p, max_new_tokens=1)
    alone = eng.submit(prompts[4], max_new_tokens=7)
    done = eng.run_until_drained()
    assert done[alone].tolist() == crowded[4]
    other_seed = _drain(_port_engine(temperature=0.8, seed=4), prompts, 7)
    assert other_seed != crowded


@pytest.mark.parametrize("kind", ["none", "int8"])
def test_spec_equals_sequential_under_temperature(kind):
    """The analog of the reference's test_spec_temperature_bit_identical:
    drafts and verify sample under the keys sequential decode uses, so the
    spec engine emits the non-spec engine's tokens at T > 0."""
    warm = dict(kv_quant=kind, temperature=0.7, seed=1, max_slots=2, decode_chunk=8)
    want = _drain(_port_engine(**warm), _prompts(), 12)
    eng = _port_engine(spec_decode=SpecConfig(k=3, draft_codec="nf4"), **warm)
    got = _drain(eng, _prompts(), 12)
    assert got == want
    assert eng.scheduler.stats()["verify_calls"] > 0


def test_engine_keys_and_temperature_live_on_its_device():
    eng = _port_engine(temperature=0.25, seed=2**32 + 9)
    assert eng._key.tolist() == [0, 9] and eng._key.dtype == torch.int64
    assert eng._temp.dtype == torch.float32 and float(eng._temp) == 0.25
    assert not eng.greedy and _port_engine().greedy
