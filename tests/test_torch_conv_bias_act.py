"""The convolution epilogue (``ops/kernels.py::conv_bias_act``, the kernel
in ``csrc/conv_epilogue.cu``) and WaterNet's route to it
(``ops/kernels.py::kernel_route``).

On the CPU: the plain version against ``act(y + b)``, and the forward's
route, which leaves the CPU, training under grad and ``torch.export`` on
the ops the forward has always run, bit for bit. On the card (marked
``card``, skipped without one): the kernel against the plain version at
each of WaterNet's layer widths, byte for byte; the wrapper's refusals;
17 launches a forward; and a no-grad forward byte-equal to the same
module's forward under grad, in one process (cuDNN's choice of algorithm
is pinned only within a process). This file imports no JAX, so the card
cases run on a machine without it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_conv_bias_act.py
"""

import types
from pathlib import Path

import pytest
import torch
from torch import nn

from waternet_tpu_torch.hub import build_model, resolve_weights, run_model
from waternet_tpu_torch.models import waternet as wn
from waternet_tpu_torch.ops import kernels

TEACHER = str(Path(__file__).parent / "fixtures" / "distill" / "teacher.npz")
ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid}
# WaterNet's output widths and each one's activation: the CMG's 128- and
# 64-channel layers and its 3-channel sigmoid, the refiners' 32 channels
# and their 3-channel ReLU.
LAYERS = [(128, "relu"), (64, "relu"), (32, "relu"), (3, "sigmoid"), (3, "relu")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card")
    return torch.device("cuda")


def _output(shape, dtype, seed, device="cpu"):
    """A seeded (N, C, H, W) channels-last tensor, as cuDNN writes a
    convolution's output."""
    n, c, h, w = shape
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((n, h, w, c), generator=g).to(dtype).permute(0, 3, 1, 2)
    return y.to(device)


def _bias(c, seed):
    return torch.randn(c, generator=torch.Generator().manual_seed(seed)) * 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "sigmoid"])
@pytest.mark.parametrize("c", [3, 32, 64, 128])
def test_plain_is_act_of_sum(c, act, dtype):
    """In place, rounded as ``act(y + b)`` with the bias in y's dtype; a
    float32 bias rounds to y's dtype first, as autocast casts it."""
    y = _output((2, c, 5, 7), dtype, c)
    b = _bias(c, c + 1)
    want = ACTS[act](y + b.to(dtype).reshape(1, -1, 1, 1))
    got = y.clone(memory_format=torch.channels_last)
    assert kernels.conv_bias_act(got, b, act) is got
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    same = kernels.conv_bias_act_plain(y.clone(), b.to(dtype), act)
    assert torch.equal(same, want)


def test_unknown_activation_is_refused():
    with pytest.raises(ValueError, match="act must be one of"):
        kernels.conv_bias_act(_output((1, 3, 2, 2), torch.float32, 0), torch.zeros(3), "gelu")


def _parent_forward(model, x, wb, ce, gc):
    """WaterNet's forward as it ran before the route: biased convolutions,
    then torch.relu / torch.sigmoid."""
    def cmg(t):
        for i in range(1, 8):
            t = torch.relu(getattr(model.cmg, f"conv{i}")(t))
        out = torch.sigmoid(model.cmg.conv8(t))
        return out[:, 0:1], out[:, 1:2], out[:, 2:3]

    def refine(r, t):
        return torch.relu(r.conv3(torch.relu(r.conv2(torch.relu(r.conv1(t))))))

    x, wb, ce, gc = (t.permute(0, 3, 1, 2) for t in (x, wb, ce, gc))
    wb_cm, ce_cm, gc_cm = cmg(torch.cat([x, wb, ce, gc], dim=1))
    out = (
        refine(model.wb_refiner, torch.cat([x, wb], dim=1)) * wb_cm
        + refine(model.ce_refiner, torch.cat([x, ce], dim=1)) * ce_cm
        + refine(model.gc_refiner, torch.cat([x, gc], dim=1)) * gc_cm
    )
    return out.permute(0, 2, 3, 1)


def _inputs(shape, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(shape, generator=g).to(device) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", ["no_grad", "enable_grad"])
def test_cpu_forward_is_the_parents_ops(monkeypatch, grad, dtype):
    """On the CPU, with grad on or off, the forward never reaches the
    epilogue and equals the parent's forward bit for bit."""
    def refuse(*args):
        raise AssertionError("conv_bias_act reached on the CPU")

    monkeypatch.setattr(wn, "conv_bias_act", refuse)
    model = build_model(resolve_weights(TEACHER), "cpu")
    inputs = _inputs((2, 19, 23, 3), 3)
    kernels.reset_launches()
    with getattr(torch, grad)():
        got = run_model(model, dtype, *inputs)
        if dtype == torch.float32:
            want = _parent_forward(model, *inputs)
        else:
            with torch.autocast("cpu", dtype=dtype):
                want = _parent_forward(model, *inputs).to(torch.float32)
    assert torch.equal(got, want)
    assert kernels.LAUNCHES["conv_bias_act"] == 0


def test_route_follows_device_grad_and_tracing():
    """The route is a CUDA input with grad off and nothing tracing: grad on
    (training) and ``torch.export`` keep the parent's ops."""
    on_card = types.SimpleNamespace(is_cuda=True)
    with torch.no_grad():
        assert kernels.kernel_route(on_card)
        assert not kernels.kernel_route(torch.zeros(1))
    with torch.inference_mode():
        assert kernels.kernel_route(on_card)
    with torch.enable_grad():
        assert not kernels.kernel_route(on_card)

    seen = []

    class Probe(nn.Module):
        def forward(self, x):
            seen.append(kernels.kernel_route(on_card))
            return x + 1

    with torch.no_grad():
        torch.export.export(Probe(), (torch.ones(2),))
    assert seen == [False]


def test_export_keeps_the_biased_convolutions_and_activations():
    """The exported graph holds 17 biased convolutions, 16 ReLUs and one
    sigmoid, and no call into this package: an artifact runs without it."""
    model = build_model(resolve_weights(TEACHER), "cpu")
    example = tuple(_inputs((1, 16, 20, 3), 4))
    with torch.no_grad():
        ep = torch.export.export(model, example)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    convs = [n for n in ep.graph.nodes if n.op == "call_function" and "conv" in str(n.target)]
    assert len(convs) == 17
    assert all(n.args[2] is not None for n in convs)  # the bias rides on the convolution
    assert sum("relu" in t for t in targets) == 16
    assert sum("sigmoid" in t for t in targets) == 1
    assert not any("waternet" in t for t in targets)


# -- on the card ---------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,act", LAYERS)
def test_kernel_equals_plain_at_each_layer(card, c, act, dtype):
    """Byte for byte the plain version (ATen's add_ then relu_/sigmoid_ on
    the card) at each layer's width over an odd plane, with a float32 and
    a same-dtype bias, and from an address that is not 16-byte aligned."""
    shape = (2, c, 135, 241)
    b = _bias(c, 7).to(card)
    for bias in (b, b.to(dtype)):
        y = _output(shape, dtype, c, card).contiguous(memory_format=torch.channels_last)
        want = kernels.conv_bias_act_plain(y.clone(memory_format=torch.channels_last), bias, act)
        kernels.reset_launches()
        assert kernels.conv_bias_act(y, bias, act) is y
        assert kernels.LAUNCHES["conv_bias_act"] == 1
        assert torch.equal(y.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    n, _, h, w = shape
    buf = torch.empty(n * h * w * c + 1, dtype=dtype, device=card)
    odd = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    odd.copy_(_output(shape, dtype, c + 2, card))
    want = kernels.conv_bias_act_plain(odd.clone(memory_format=torch.channels_last), b, act)
    kernels.conv_bias_act(odd, b, act)
    assert torch.equal(odd, want)


@pytest.mark.card
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    b = torch.zeros(32, device=card)
    nchw = torch.zeros((2, 32, 5, 7), device=card)
    with pytest.raises(ValueError, match="channels-last"):
        kernels.conv_bias_act(nchw, b, "relu")
    cl = nchw.contiguous(memory_format=torch.channels_last)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="y: expected"):
            kernels.conv_bias_act(cl.to(dtype), b, "relu")
    with pytest.raises(TypeError, match="bias: expected"):
        kernels.conv_bias_act(cl, b.to(torch.float64), "relu")
    with pytest.raises(ValueError, match="shape"):
        kernels.conv_bias_act(cl, torch.zeros(31, device=card), "relu")
    with pytest.raises(ValueError, match="device"):
        kernels.conv_bias_act(cl, b.cpu(), "relu")
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        kernels.conv_bias_act(torch.zeros((2, 32, 5), device=card), b, "relu")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_launches_17_and_equals_the_grad_forward(card, dtype):
    """A no-grad forward on the card launches the epilogue once per
    convolution, 17 in all, and is byte-equal to the same module's forward
    under grad (the parent's ops) on the same inputs, in one process."""
    model = build_model(resolve_weights(TEACHER), card)
    inputs = _inputs((2, 67, 101, 3), 5, card)
    with torch.enable_grad():
        want = run_model(model, dtype, *inputs).detach()
    kernels.reset_launches()
    for k in range(2):
        with torch.inference_mode():
            got = run_model(model, dtype, *inputs)
        assert kernels.LAUNCHES["conv_bias_act"] == 17 * (k + 1)
        assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(run_model(model, dtype, *inputs), want)
    assert kernels.LAUNCHES["conv_bias_act"] == 51
