"""Restormer's depthwise 3x3 kernel (``ops/kernels.py::dwconv3x3``, the
kernel in ``csrc/dwconv.cu``) and the model's route to it
(``models/restormer.py::_dwconv``).

On the CPU: the plain version against a 9-tap sum and the exact-erf GELU
gate written out here, at Restormer's eight depthwise widths; the launch
plan; the wrapper's refusals; and Restormer's forward on the CPU, with
grad on or off, byte-equal to the ops it ran before the route, with no
launch. On the card (marked ``card``, skipped without one): the identity
epilogue within one bf16 unit in the last place of the float32
convolution, the gate byte-equal to the eager gate over the identity's
output, float32 against the float32 plain version, at odd, ragged and
unaligned shapes, and a published-width bf16 no-grad forward with 44 + 44
launches. This file imports no JAX, so the card cases run on a machine
without it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dwconv.py
"""

import math

import pytest
import torch
import torch.nn.functional as F

from waternet_tpu_torch.models import restormer as rmod
from waternet_tpu_torch.ops import kernels

#: The depthwise convs' input channels at the published widths: MDTA's 3C
#: (C = 48, 96, 192, 384) and GDFN's 2h (h = int(2.66 C)).
WIDTHS = [144, 254, 288, 510, 576, 1020, 1152, 2042]
SMALL = {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement_blocks": 1, "heads": (1, 2, 4, 8)}
PUBLISHED = {"dim": 48, "num_blocks": (4, 6, 6, 8), "num_refinement_blocks": 4, "heads": (1, 2, 4, 8)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card")
    return torch.device("cuda")


def _inputs(n, c, h, w, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, c, h, w), generator=g).to(dtype)
    weight = torch.rand((c, 1, 3, 3), generator=g) * (2 / 3) - 1 / 3  # Conv2d's bound at fan-in 9
    return x, weight


def _taps(x, weight):
    """The depthwise 3x3 convolution as 9 shifted products of the
    zero-padded planes, summed in float64."""
    xp = F.pad(x.double(), (1, 1, 1, 1))
    h, w = x.shape[2:]
    k = weight.double().view(1, -1, 3, 3)
    return sum(xp[:, :, dy:dy + h, dx:dx + w] * k[:, :, dy:dy + 1, dx:dx + 1]
               for dy in range(3) for dx in range(3))


def _gate(y):
    y1, y2 = y.chunk(2, dim=1)
    return 0.5 * y1 * (1 + torch.erf(y1 / math.sqrt(2))) * y2


# -- on the CPU -----------------------------------------------------------------


@pytest.mark.parametrize("gate", [False, True], ids=["identity", "gate"])
@pytest.mark.parametrize("c", WIDTHS)
def test_plain_is_the_taps_and_the_gate(c, gate):
    """Float32, at an odd plane and one whose width is not a multiple of
    8: the plain version (and the wrapper, which takes it for CPU tensors)
    is the 9-tap sum, and with ``gate`` GELU's exact form of the first
    half times the second."""
    for n, h, w in ((1, 7, 13), (2, 12, 20)):
        x, weight = _inputs(n, c, h, w, c + h)
        want = _taps(x, weight)
        if gate:
            want = _gate(want)
        got = kernels.dwconv3x3_plain(x, weight, gate)
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
        assert torch.equal(kernels.dwconv3x3(x, weight, gate), got)


@pytest.mark.parametrize("gate", [False, True], ids=["identity", "gate"])
@pytest.mark.parametrize("h,w,rows,gate_rows,vec", [
    (1080, 1920, 32, 270, 1), (540, 960, 32, 270, 1), (270, 480, 30, 270, 1), (135, 240, 27, 135, 1),
    (7, 13, 7, 7, 0), (67, 248, 23, 67, 1), (600, 40, 32, 200, 1),
])
def test_plan_cuts_even_bands_and_vectorises_whole_rows(h, w, rows, gate_rows, vec, gate):
    want = gate_rows if gate else rows
    assert kernels.dwconv_plan(h, w, 4096, 8192, gate) == (want, vec)
    assert kernels.dwconv_plan(h, w, 4096 + 2, 8192, gate) == (want, 0)


def _refusal_cases():
    x = torch.zeros((2, 6, 5, 7))
    w = torch.zeros((6, 1, 3, 3))
    return {
        "ndim": (x[0], w, False, ValueError, r"\(N, C, H, W\)"),
        "float16": (x.half(), w, False, TypeError, "x: expected"),
        "float64": (x.double(), w, False, TypeError, "x: expected"),
        "weight_dtype": (x, w.double(), False, TypeError, "weight: expected"),
        "weight_shape": (x, torch.zeros((6, 1, 5, 5)), False, ValueError, "shape"),
        "weight_channels": (x, torch.zeros((5, 1, 3, 3)), False, ValueError, "shape"),
        "channels_last": (x.contiguous(memory_format=torch.channels_last), w, False, ValueError,
                          "contiguous NCHW"),
        "odd_gate": (torch.zeros((2, 5, 5, 7)), w[:5], True, ValueError, "even"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, w, gate, err, match = _refusal_cases()[case]
    with pytest.raises(err, match=match):
        kernels.dwconv3x3(x, w, gate)
    with pytest.raises(err, match=match):
        kernels.dwconv3x3_plain(x, w, gate)


def _parent_attention(self, x):
    """``Attention.forward`` as it ran before the route."""
    b, h, w, c = x.shape
    qkv = self.qkv_dwconv(rmod._project_in(self.qkv, x)).flatten(2)
    q, k, v = qkv.split(c, dim=1)
    with torch.autocast(x.device.type, enabled=False):
        mixing = self._mixing(q, k)
        out = torch.bmm(v.transpose(1, 2), mixing.transpose(1, 2).to(v.dtype))
    return out.view(b, h, w, c)


def _parent_ffn(self, x):
    """``FeedForward.forward`` as it ran before the route."""
    x1, x2 = self.dwconv(rmod._project_in(self.project_in, x)).chunk(2, dim=1)
    return rmod._project_out(self.project_out, F.gelu(x1) * x2)


def _model(cfg, seed, dtype, device="cpu"):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = rmod.Restormer(**cfg, dtype=dtype)
    return model.to(device).eval()


def _frames(shape, seed, device="cpu"):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed)).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", ["no_grad", "enable_grad"])
def test_cpu_forward_is_the_parents_ops(monkeypatch, grad, dtype):
    """On the CPU, with grad on or off, the forward never reaches the
    wrapper and equals the parent's forward byte for byte."""
    model = _model(SMALL, 2, dtype)
    x = _frames((2, 21, 27, 3), 3)
    with getattr(torch, grad)():
        with monkeypatch.context() as m:
            m.setattr(rmod.Attention, "forward", _parent_attention)
            m.setattr(rmod.FeedForward, "forward", _parent_ffn)
            want = model(x)

        def refuse(*args):
            raise AssertionError("dwconv3x3 reached on the CPU")

        monkeypatch.setattr(rmod, "dwconv3x3", refuse)
        kernels.reset_launches()
        got = model(x)
    assert torch.equal(got, want)
    assert kernels.LAUNCHES["dwconv3x3"] == kernels.LAUNCHES["dwconv3x3_gelu_gate"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_hands_each_block_its_weights_and_gate(monkeypatch, dtype):
    """Where the route is taken, each block hands the wrapper its own
    float32 depthwise weight, MDTA's without the gate and GDFN's with it;
    with the plain version behind the wrapper the forward is the parent's
    module ops, byte for byte, so the halves and the weights are wired
    right."""
    model = _model(SMALL, 4, dtype)
    x = _frames((1, 16, 24, 3), 5)
    with torch.no_grad():
        with monkeypatch.context() as m:
            m.setattr(rmod.Attention, "forward", _parent_attention)
            m.setattr(rmod.FeedForward, "forward", _parent_ffn)
            want = model(x)
        calls = []

        def plain(t, weight, gate):
            calls.append((weight, gate))
            return kernels.dwconv3x3_plain(t, weight, gate)

        monkeypatch.setattr(rmod, "kernel_route", lambda t: True)
        monkeypatch.setattr(rmod, "dwconv3x3", plain)
        got = model(x)
    assert torch.equal(got, want)
    blocks = [m for m in model.modules() if isinstance(m, rmod.TransformerBlock)]
    assert len(calls) == 2 * len(blocks) == 16
    for (wa, ga), (wf, gf), blk in zip(calls[::2], calls[1::2], blocks):
        assert (ga, gf) == (False, True)
        assert wa is blk.attn.qkv_dwconv.weight and wf is blk.ffn.dwconv.weight
        assert wa.dtype == wf.dtype == torch.float32


# -- on the card ---------------------------------------------------------------


def _ulps_bf16(got, want):
    """|got - want| in units of the last place of bf16 at ``want``."""
    e = torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
    return (got.double() - want).abs() / torch.exp2(e - 7)


#: (n, h, w, offset): a 1080p-like plane cut down, an odd one with several
#: bands and segments, a ragged width, and an address 2 bytes off 16.
SHAPES = [(2, 40, 240, 0), (1, 67, 496, 0), (2, 33, 37, 0), (1, 19, 248, 1)]


def _on_card(x, dev, offset):
    """``x`` on the card, at ``offset`` elements past a 16-byte-aligned
    allocation (not 16-byte aligned for offset 1)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
    out = buf[offset:].view(x.shape)
    out.copy_(x.to(dev))
    return out


@pytest.mark.card
@pytest.mark.parametrize("c", WIDTHS)
def test_identity_within_one_bf16_ulp_of_float32(card, c):
    for n, h, w, offset in SHAPES:
        x, weight = _inputs(n, c, h, w, c + w, torch.bfloat16)
        xd = _on_card(x, card, offset)
        kernels.reset_launches()
        got = kernels.dwconv3x3(xd, weight.to(card), False)
        assert kernels.LAUNCHES["dwconv3x3"] == 1
        assert got.dtype == torch.bfloat16 and got.shape == x.shape and got.is_contiguous()
        want = kernels.dwconv3x3_plain(x.float(), weight.to(torch.bfloat16).float(), False).double()
        assert float(_ulps_bf16(got.cpu(), want).max()) <= 1.0, (n, h, w, offset)
        # A bf16 weight is the float32 one rounded: the same bytes.
        assert torch.equal(kernels.dwconv3x3(xd, weight.to(card, torch.bfloat16), False), got)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [254, 510, 1020, 2042])
def test_gate_equals_the_eager_gate_over_the_identity(card, c, dtype):
    """Byte for byte ``F.gelu(y1) * y2`` over the identity epilogue's
    output ``y``, as the eager path computes it on the card."""
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for n, h, w, offset in SHAPES:
        x, weight = _inputs(n, c, h, w, c + h, dtype)
        xd, wd = _on_card(x, card, offset), weight.to(card)
        y1, y2 = kernels.dwconv3x3(xd, wd, False).chunk(2, dim=1)
        want = F.gelu(y1) * y2
        kernels.reset_launches()
        got = kernels.dwconv3x3(xd, wd, True)
        assert kernels.LAUNCHES["dwconv3x3_gelu_gate"] == 1
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.equal(got.view(bits), want.view(bits)), (n, h, w, offset)


@pytest.mark.card
def test_gate_is_the_eager_gate_at_every_bf16_value(card):
    """The bf16 gate's GELU (the exact erf form) is the eager ``F.gelu`` at
    each of the 65,536 bf16 values: a centre-tap weight makes
    the first half's convolution the value itself, a gap of one zero row and
    column keeps the values apart, and the second half reads 1."""
    vals = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).view(256, 256)
    x = torch.zeros((1, 2, 512, 512), dtype=torch.bfloat16)
    x[0, 0, ::2, ::2] = vals
    x[0, 1, ::2, ::2] = 1.0
    weight = torch.zeros((2, 1, 3, 3))
    weight[:, 0, 1, 1] = 1.0
    xd, wd = x.to(card), weight.to(card)
    y = kernels.dwconv3x3(xd, wd, False)
    assert torch.equal(y[0, 0, ::2, ::2].isnan(), vals.to(card).isnan())
    want = F.gelu(y[:, :1]) * y[:, 1:]
    got = kernels.dwconv3x3(xd, wd, True)
    same = (got.view(torch.int16) == want.view(torch.int16)) | (got.isnan() & want.isnan())
    assert bool(same.all()), int((~same).sum())


@pytest.mark.card
@pytest.mark.parametrize("gate", [False, True], ids=["identity", "gate"])
@pytest.mark.parametrize("c", [144, 510])
def test_float32_matches_the_float32_plain_version(card, c, gate):
    """Float32 FMAs, never TF32: the plain version's convolution on the
    card runs with TF32 off, and the two differ only by the order of 9
    float32 products."""
    torch.backends.cudnn.allow_tf32 = False
    for n, h, w, offset in SHAPES:
        x, weight = _inputs(n, c, h, w, c + 1)
        xd, wd = _on_card(x, card, offset), weight.to(card)
        got = kernels.dwconv3x3(xd, wd, gate)
        want = _taps(x, weight)
        torch.testing.assert_close(got.cpu().double(), _gate(want) if gate else want, rtol=2e-6, atol=2e-6)


@pytest.mark.card
def test_card_forward_launches_44_of_each_and_stays_near_float32(card):
    """A published-width bf16 no-grad forward launches each epilogue once
    a block, 44 of each, and lands as close to the float32 forward as the
    same module's bf16 forward under grad (ATen's kernels and the eager
    gate); 2 no-grad calls give the same bytes."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _model(PUBLISHED, 6, torch.bfloat16, card)
    x = _frames((1, 64, 96, 3), 7, card)
    with torch.enable_grad():
        eager = model(x).detach()
    model.dtype = torch.float32
    with torch.enable_grad():
        ref = model(x).detach()
    model.dtype = torch.bfloat16
    kernels.reset_launches()
    with torch.inference_mode():
        got = model(x)
        assert kernels.LAUNCHES["dwconv3x3"] == kernels.LAUNCHES["dwconv3x3_gelu_gate"] == 44
        again = model(x)
    assert kernels.LAUNCHES["dwconv3x3"] == kernels.LAUNCHES["dwconv3x3_gelu_gate"] == 88
    assert torch.equal(got, again)
    err, err_eager = (got - ref).abs(), (eager - ref).abs()
    assert float(err.max()) <= 1.5 * float(err_eager.max()) + 1e-3
    assert float(err.mean()) <= 1.5 * float(err_eager.mean()) + 1e-4
