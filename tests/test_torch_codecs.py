"""Parity of the port's codecs and compression with the JAX reference.

Bitwise throughout: codec decode over every byte and nibble, scale decode,
`compress` planes for every codec and density, KV encode/decode including
rounding ties. Inputs are made by numpy from a seed and handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as jcodecs
from repro.core.compression import compress as jcompress
from repro.core.formats import CompressionSpec as JSpec

from repro_torch.core import codecs as tcodecs
from repro_torch.core.compression import compress as tcompress
from repro_torch.core.formats import CompressionSpec, get_spec
from repro_torch.convert import to_tensor

CODECS = ("bf16", "bf8", "mxfp4", "int8", "int4", "nf4")
KV_CODECS = ("bf8", "int8", "int4", "mxfp4", "nf4")


def _bits_equal(a, b) -> bool:
    """Bitwise equality of f32 arrays, every NaN pattern counting as NaN
    (XLA may canonicalize NaN payloads on conversion)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    nan = np.isnan(a)
    return bool(
        np.array_equal(nan, np.isnan(b))
        and np.array_equal(a[~nan].view(np.uint32), b[~nan].view(np.uint32))
    )


def _all_codes(name):
    """Every stored code of the codec as a (1, packed, N) plane: all 65536
    byte pairs for bf16, all 256 bytes (so all 16 nibbles in both halves)
    otherwise."""
    if name == "bf16":
        v = np.arange(65536, dtype=np.uint32)
        return np.stack([v & 0xFF, v >> 8]).astype(np.uint8)[None]
    return np.arange(256, dtype=np.uint8).reshape(1, 2, 128)


@pytest.mark.parametrize("name", CODECS)
def test_decode_values_every_code_bitwise(name):
    codes = _all_codes(name)
    ref = np.asarray(jcodecs.get_codec(name).decode_values(jnp.asarray(codes)))
    got = tcodecs.get_codec(name).decode_values(torch.from_numpy(codes)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert _bits_equal(got, ref)


def test_decode_scales_bf16_bits_every_pattern():
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16).reshape(256, 256)
    ref = np.asarray(jcodecs.get_codec("int8").decode_scales(jnp.asarray(bits)))
    got = tcodecs.get_codec("int8").decode_scales(to_tensor(bits, "cpu")).numpy()
    assert _bits_equal(got, ref)


def test_decode_scales_e8m0_exact_powers_of_two():
    """E8M0 decodes to exact 2**(u-127) for all 256 bytes. The reference's
    `jnp.exp2` on XLA:CPU agrees only for u in [115, 139] (and 113): it
    flushes 2**-127 and 2**-126 to zero and is off by ulps further out
    (ROADMAP Queue C). Every weight group with scale in 2**-12..2**12 uses
    that range, so compressed weights decode identically."""
    u = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = tcodecs.get_codec("mxfp4").decode_scales(torch.from_numpy(u)).numpy()
    with np.errstate(over="ignore"):
        exact = np.ldexp(np.float32(1), u.astype(np.int32) - 127).astype(np.float32)
    assert _bits_equal(got, exact)
    ref = np.asarray(jcodecs.get_codec("mxfp4").decode_scales(jnp.asarray(u)))
    span = (u >= 115) & (u <= 139)
    assert _bits_equal(got[span], ref[span])


def test_floor_log2_matches_numpy_near_powers_of_two():
    """The mxfp4 encoder's exponent: numpy's f32 `floor(log2(x))` rounds up
    just below a power of two; the port's bit-level table must agree."""
    rng = np.random.default_rng(0)
    xs = [rng.uniform(1e-30, 1e30, 4000).astype(np.float32)]
    for e in range(-126, 128):
        top = ((e + 127) << 23) | 0x7FFFFF
        xs.append(np.arange(top - 64, top + 1, dtype=np.uint32).view(np.float32))
        xs.append(np.array([(e + 127) << 23], np.uint32).view(np.float32))
    x = np.concatenate(xs)
    ref = np.floor(np.log2(x)).astype(np.int32)
    got = tcodecs.floor_log2_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref)


def _weights(k, n, seed):
    """Normal weights with the awkward cases the codecs must agree on:
    exact zeros, repeated magnitudes (sort ties), and group maxima just
    below powers of two (mxfp4 exponent rounding)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[rng.random((k, n)) < 0.05] = 0.0
    w[3, :] = w[4, :]
    w[5, : n // 2] = -w[6, : n // 2]
    below = np.array([0x3EFFFFFF, 0x3DFFFFFE, 0x3F7FFFFF], np.uint32).view(np.float32)
    w[32 + np.arange(3), 7] = below
    return w


@pytest.mark.parametrize("density", [1.0, 0.5, 0.05])
@pytest.mark.parametrize("quant", CODECS)
def test_compress_planes_bitwise(quant, density):
    w = _weights(128, 48, seed=CODECS.index(quant) * 100 + int(density * 100))
    ref = jcompress(w, JSpec(quant, density))
    got = tcompress(torch.from_numpy(w), CompressionSpec(quant, density))
    assert got.shape == ref.shape
    assert np.array_equal(got.codes.numpy(), np.asarray(ref.codes))
    for plane in ("mask", "scales"):
        r, g = getattr(ref, plane), getattr(got, plane)
        assert (r is None) == (g is None)
        if r is not None:
            assert np.array_equal(g.numpy(), to_tensor(r, "cpu").numpy())
    assert got.nbytes == ref.nbytes == CompressionSpec(quant, density).bytes_for(128, 48)


@pytest.mark.parametrize("quant", CODECS)
def test_offline_decode_matches_reference_numpy_codec(quant):
    """encode then decode (codes + stored scales -> values), bitwise
    against the reference's numpy codec on the same packed values."""
    rng = np.random.default_rng(11)
    vals = (rng.standard_normal((4, 32, 24)) * 0.05).astype(np.float32)
    jc, tc = jcodecs.get_codec(quant), tcodecs.get_codec(quant)
    codes_r, scales_r = jc.encode(vals)
    codes_g, scales_g = tc.encode(torch.from_numpy(vals))
    r = jc.decode(codes_r, scales_r)
    g = tc.decode(codes_g, scales_g).numpy()
    assert _bits_equal(g, r)


def test_compress_accepts_bf16_weights_on_their_device():
    w = torch.from_numpy(_weights(64, 32, seed=3)).to(torch.bfloat16)
    ct = tcompress(w, get_spec("int4_50"))
    assert ct.device == w.device and ct.codes.dtype == torch.uint8
    ref = jcompress(w.float().numpy(), JSpec("int4", 0.5))
    assert np.array_equal(ct.codes.numpy(), np.asarray(ref.codes))


def _kv_inputs(name, seed):
    """(rows, Dh) bf16 KV vectors: random rows plus rows whose quotients by
    the stored scale land exactly on rounding ties (half-to-even)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    if name in ("int8", "int4"):
        qmax = 127 if name == "int8" else 7
        s = 2.0 ** -4  # amax / qmax is this exact power of two
        tie = (np.arange(32) % (2 * qmax) - qmax + 0.5) * s
        tie[0] = qmax * s
        x[:8] = np.clip(tie, -qmax * s, qmax * s)
    elif name == "mxfp4":
        s = 2.0 ** -3  # amax 6 * s
        tie = np.resize([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, -0.25], 32) * s
        tie[0] = 6 * s
        x[:8] = tie
    return jnp.asarray(x).astype(jnp.bfloat16)


@pytest.mark.parametrize("name", KV_CODECS)
def test_kv_encode_decode_bitwise_with_ties(name):
    xj = _kv_inputs(name, seed=len(name))
    jc = jcodecs.get_codec(name)
    codes_r, scales_r = jc.kv_encode(xj)
    xt = to_tensor(np.asarray(xj), "cpu")
    tc = tcodecs.get_codec(name)
    codes_g, scales_g = tc.kv_encode(xt)
    assert np.array_equal(codes_g.numpy(), np.asarray(codes_r))
    assert (scales_r is None) == (scales_g is None)
    if scales_r is not None:
        assert np.array_equal(
            scales_g.view(torch.int16).numpy(),
            np.asarray(scales_r).view(np.int16),
        )
    dec_r = np.asarray(jc.kv_decode(codes_r, scales_r).astype(jnp.float32))
    dec_g = tc.kv_decode(codes_g, scales_g).to(torch.float32).numpy()
    assert _bits_equal(dec_g, dec_r)


def test_registry_and_wire_ids_match_reference():
    assert tcodecs.codec_names() == jcodecs.codec_names()
    assert tcodecs.kv_codec_names() == jcodecs.kv_codec_names()
    for n in ("none",) + CODECS:
        assert tcodecs.codec_wire_id(n) == jcodecs.codec_wire_id(n)
    for n in CODECS:
        a, b = tcodecs.get_codec(n), jcodecs.get_codec(n)
        assert (a.bits, a.scale_kind, a.kv_capable) == (b.bits, b.scale_kind, b.kv_capable)
    with pytest.raises(ValueError):
        tcodecs.get_codec("fp3")


@pytest.mark.parametrize("name", ["bf8_50", "mxfp4", "int4_25", "nf4_100", "bf16_10"])
def test_spec_geometry_matches_reference(name):
    from repro.core.formats import get_spec as jget_spec

    a, b = get_spec(name), jget_spec(name)
    assert (a.k_cap, a.name, a.bits_per_element()) == (b.k_cap, b.name, b.bits_per_element())
    assert a.bytes_for(4096, 14336) == b.bytes_for(4096, 14336)
