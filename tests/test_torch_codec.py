"""The port's cache codecs (waternet_tpu_torch.data.codec) against the JAX
package's: encoders, the dct8 kernel's plain version against the Pallas
kernel in interpret mode, the device decoders, and the budgeter.

Tolerances:
* encoders: byte-identical (the same numpy arithmetic);
* ``dct8_dequant_idct_plain`` against the Pallas kernel: f32 within
  ``atol=1e-4``. Both dequantize exactly; they sum the 16 products in
  different orders (k order here, XLA's dot there). On coefficients of
  real images the outputs stay below ~150 in magnitude, where float32's
  spacing is 1.5e-5, and measured differences are at most one such step;
* decoded uint8: within one level, on at most 0.1% of values. The f32
  difference above can carry ``x + 128`` across a rounding tie.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waternet_tpu.data import codec as jcodec
from waternet_tpu.ops import pallas_kernels as pk
from waternet_tpu_torch.data import codec
from waternet_tpu_torch.data.synthetic import SyntheticPairs
from waternet_tpu_torch.ops import kernels

SHAPES = [(2, 37, 53), (1, 64, 64), (3, 40, 24)]


def _images(n, h, w, seed=1):
    ds = SyntheticPairs(n, h, w, seed=seed)
    return np.stack([ds.load_pair(i)[i % 2] for i in range(n)])


@pytest.mark.parametrize("name", codec.CODECS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_encode_is_byte_identical_to_jax(name, shape):
    u8 = np.random.default_rng(sum(shape)).integers(0, 256, size=shape + (3,)).astype(np.uint8)
    want = jcodec.encode(name, u8)
    got = codec.encode(name, u8)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_codec_constants_match_jax():
    assert codec.CODECS == jcodec.CODECS
    assert codec.HEADROOM_SAFETY == jcodec.HEADROOM_SAFETY
    np.testing.assert_array_equal(codec.DCT8_QUANT, jcodec.DCT8_QUANT)
    np.testing.assert_array_equal(codec.DCT8_IDCT_MATRIX, jcodec.DCT8_IDCT_MATRIX)


@pytest.mark.parametrize("nb", [1, 511, 512, 1537])
def test_plain_dct8_dequant_idct_matches_pallas_interpret(nb):
    """Coefficients of real (synthetic) images, NB around the TPU kernel's
    512-block chunk."""
    coef = jcodec.encode("dct8", _images(12, 64, 64))["coef"].reshape(-1, 16)[:nb]
    assert coef.shape == (nb, 16)
    q, m = jcodec.DCT8_QUANT, jcodec.DCT8_IDCT_MATRIX
    want = np.asarray(
        pk.dct8_dequant_idct(jnp.asarray(coef), jnp.asarray(q), jnp.asarray(m), interpret=True)
    )
    got = kernels.dct8_dequant_idct(torch.from_numpy(coef), torch.from_numpy(q), torch.from_numpy(m))
    assert got.shape == (nb, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_plain_dct8_rounds_one_op_at_a_time():
    """The plain version's arithmetic, spelled out in numpy float32: the
    kernel on the card is held bit for bit against exactly this."""
    rng = np.random.default_rng(0)
    coef = rng.integers(-127, 128, size=(33, 16)).astype(np.int8)
    q, m = codec.DCT8_QUANT, codec.DCT8_IDCT_MATRIX
    deq = coef.astype(np.float32) * q
    acc = deq[:, 0:1] * m[0]
    for k in range(1, 16):
        acc = (acc + (deq[:, k : k + 1] * m[k]).astype(np.float32)).astype(np.float32)
    got = kernels.dct8_dequant_idct(torch.from_numpy(coef), torch.from_numpy(q), torch.from_numpy(m))
    assert got.numpy().tobytes() == acc.tobytes()


def _old_dct8_decode(coef5, quant, idct_m, height, width):
    """The dct8 decode as data/codec.py spelled it before the epilogue moved
    into the kernel: plain f32 product, then relayout, crop and rounding in
    eager torch."""
    b, nby, nbx, c, z2 = coef5.shape
    pix = kernels.dct8_dequant_idct_plain(coef5.reshape(b * nby * nbx * c, z2), quant, idct_m)
    img = pix.reshape(b, nby, nbx, c, 8, 8).permute(0, 1, 4, 2, 5, 3)
    img = img.reshape(b, nby * 8, nbx * 8, c)[:, :height, :width]
    return torch.clamp(torch.round(img + 128.0), 0, 255).to(torch.uint8)


@pytest.mark.parametrize("shape", SHAPES + [(2, 100, 130)], ids=lambda s: "x".join(map(str, s)))
def test_dct8_decode_u8_plain_is_the_old_epilogue(shape):
    """Bit for bit, including the crop of partial blocks (37x53, 100x130)."""
    n, h, w = shape
    coef5 = torch.from_numpy(codec.encode("dct8", _images(n, h, w))["coef"])
    q, m = torch.from_numpy(codec.DCT8_QUANT), torch.from_numpy(codec.DCT8_IDCT_MATRIX)
    want = _old_dct8_decode(coef5, q, m, h, w)
    got = kernels.dct8_decode_u8_plain(coef5, q, m, h, w)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, h, w, 3)
    assert torch.equal(got, want)
    assert torch.equal(kernels.dct8_decode_u8(coef5, q, m, h, w), want)  # CPU: the plain version


@pytest.mark.parametrize("name", ["raw", "yuv420", "dct8"])
@pytest.mark.parametrize(
    "shape", SHAPES + [(2, 256, 256), (2, 100, 130)], ids=lambda s: "x".join(map(str, s))
)
def test_decode_matches_jax_within_one_level(name, shape):
    u8 = _images(*shape)
    want = jcodec.roundtrip(name, u8)
    payload = {k: torch.from_numpy(v) for k, v in codec.encode(name, u8).items()}
    got = codec.decode(name, payload, shape[1], shape[2])
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape + (3,)
    diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_lossy_decode_quality_on_smooth_content():
    """The ladder's point: dct8 keeps smooth content above 40 dB."""
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    img = np.stack([100 + 60 * np.sin(xx / 19.0) * np.cos(yy / 13.0)] * 3, axis=-1)
    u8 = np.clip(img, 0, 255).astype(np.uint8)[None]
    for name in ("yuv420", "dct8"):
        payload = {k: torch.from_numpy(v) for k, v in codec.encode(name, u8).items()}
        err = codec.decode(name, payload, 64, 64).numpy().astype(np.float64) - u8
        assert 10.0 * np.log10(255.0**2 / np.mean(err**2)) >= 40.0


_N, _HW = 8, 32  # the sizes of tests/test_codec.py's budgeter tests


@pytest.mark.parametrize("headroom", [None, 10_000, 20_000, 60_000, 300_000])
@pytest.mark.parametrize("precache", [False, True])
def test_budget_report_matches_jax(headroom, precache):
    kw = dict(headroom=headroom, precache_histeq=precache)
    assert codec.budget_report(_N, _HW, _HW, **kw) == jcodec.budget_report(_N, _HW, _HW, **kw)
    assert codec.report_lines(codec.budget_report(_N, _HW, _HW, **kw), headroom) == jcodec.report_lines(
        jcodec.budget_report(_N, _HW, _HW, **kw), headroom
    )


@pytest.mark.parametrize("requested", ["auto", "raw", "yuv420", "dct8"])
@pytest.mark.parametrize("headroom", [None, 10_000, 20_000, 60_000, 300_000])
def test_choose_codec_matches_jax(requested, headroom):
    kw = dict(headroom=headroom, precache_histeq=True)
    try:
        want = jcodec.choose_codec(requested, _N, _HW, _HW, **kw)
    except jcodec.CacheBudgetError as e:
        with pytest.raises(codec.CacheBudgetError) as got:
            codec.choose_codec(requested, _N, _HW, _HW, **kw)
        assert str(got.value) == str(e)
        return
    assert codec.choose_codec(requested, _N, _HW, _HW, **kw) == want


def test_estimates_match_jax_at_odd_sizes():
    for name in codec.CODECS:
        for h, w in ((33, 47), (256, 256), (112, 100)):
            assert codec.encoded_bytes_per_image(name, h, w) == jcodec.encoded_bytes_per_image(name, h, w)
            assert codec.decode_flops_per_image(name, h, w) == jcodec.decode_flops_per_image(name, h, w)
            for pre in (False, True):
                assert codec.estimate_cache_bytes(name, 5, h, w, precache_histeq=pre) == (
                    jcodec.estimate_cache_bytes(name, 5, h, w, precache_histeq=pre)
                )


def test_headroom_env_override_and_cpu(monkeypatch):
    monkeypatch.setenv("WATERNET_CACHE_HEADROOM_BYTES", "12345")
    assert codec.resolve_headroom("cpu") == 12345
    monkeypatch.delenv("WATERNET_CACHE_HEADROOM_BYTES")
    assert codec.resolve_headroom("cpu") is None
    assert codec.resolve_headroom() is None


def test_unknown_codec_rejected():
    for fn in (
        lambda: codec.encode("png", np.zeros((1, 8, 8, 3), np.uint8)),
        lambda: codec.decode("png", {}, 8, 8),
        lambda: codec.encoded_bytes_per_image("png", 8, 8),
        lambda: codec.choose_codec("png", 1, 8, 8, headroom=None),
    ):
        with pytest.raises(ValueError, match="unknown cache codec"):
            fn()
