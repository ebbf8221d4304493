"""Post-training static int8 quantization of WaterNet and the CAN student.

The port of the JAX package's ``models/quant.py``, the same scheme:

* weights: per-output-channel symmetric int8 (scale = absmax / 127 a
  channel), computed in numpy from the float checkpoint exactly as the JAX
  package computes them (``np.round`` and ``torch.round`` both round half
  to even), so the codes equal JAX's;
* activations: per-conv-input symmetric int8, the scale the running
  absmax over calibration batches / 127;
* each convolution runs int8 x int8 -> int32, EXACT, then the float
  rescale ``acc * (s_in * s_w[c]) + bias``; concats and activations stay
  float, and every conv re-quantizes its own input.

The int8 convolution (:func:`_conv_int8`) is an im2col over the int8 codes
(dilation included; SAME padding with the code 0) and ``torch._int_mm``:
cuBLASLt's IMMA GEMM on CUDA, with int32 accumulation, and the same
operator on the CPU. ``_int_mm`` on CUDA wants more than 16 rows and K and
N multiples of 8, so K is zero-padded to a multiple of 8, the weights'
output channels to one of 8 (the 3-channel heads), and a tiny batch's rows
to 17; the padding adds zero products and the result is sliced back. A
shape the card still refuses raises: there is no float emulation (a float
conv of the codes is not exact: 127^2 x 3200 is above 2^24). The im2col
of a wide layer is large (K = 128 x 5 x 5 over 4 x 1080x1920 is 26.5 GB of
int8), so eager calls take it in bands of output rows under
:data:`IM2COL_BUDGET_BYTES`; a traced call (``torch.export``, symbolic
sizes) takes it in one piece, which keeps H and W symbolic.

The qtree is ``{branch: [{"wq", "bias", "s_in", "rescale"}, ...]}`` like
the JAX package's, with torch tensors: ``wq`` int8 OIHW, ``bias`` and
``rescale`` float32 per output channel, ``s_in`` a float32 scalar.
:class:`QuantWaterNet` and :class:`QuantCAN` hold one on a device (with
each layer's GEMM operand precomputed) and are called like the float
models; their ``acc_hook`` attribute, when set, gets every
convolution's int32 accumulator (the card-against-CPU check).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from waternet_tpu_torch.models.can import can_dilations
from waternet_tpu_torch.models.waternet import _CMG_SPEC, _REFINER_SPEC

_CMG_ACTS = ["relu"] * (len(_CMG_SPEC) - 1) + ["sigmoid"]
_REFINER_ACTS = ["relu"] * len(_REFINER_SPEC)
_BRANCHES: Tuple[Tuple[str, int], ...] = (
    ("cmg", len(_CMG_ACTS)),
    ("wb_refiner", len(_REFINER_ACTS)),
    ("ce_refiner", len(_REFINER_ACTS)),
    ("gc_refiner", len(_REFINER_ACTS)),
)

#: Bytes of int8 im2col one eager band may hold.
IM2COL_BUDGET_BYTES = 1 << 30

#: ``hook(name, acc)``: a conv's whole (N, H, W, Cout) int32 accumulator,
#: ``name`` being ``"{branch}/{i}"``.
AccHook = Callable[[str, torch.Tensor], None]


def _ceil8(n):
    return -(-n // 8) * 8


def band_rows(n: int, h: int, w: int, k: int, budget: int = None) -> int:
    """Output rows one eager im2col band covers for an (n, h, w) input and
    a K-wide (padded) patch: as many as fit ``budget`` bytes, at least 1."""
    budget = IM2COL_BUDGET_BYTES if budget is None else budget
    return max(1, min(h, budget // max(1, n * w * _ceil8(k))))


def gemm_operand(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW weights -> the (Cout padded to 8, K padded to 8) int8
    matrix whose transpose is ``_int_mm``'s second operand, K ordered (kh,
    kw, cin) like the im2col's columns."""
    cout, cin, kh, kw = wq.shape
    k = kh * kw * cin
    wt = torch.zeros((_ceil8(cout), _ceil8(k)), dtype=torch.int8, device=wq.device)
    wt[:cout, :k] = wq.permute(0, 2, 3, 1).reshape(cout, k)
    return wt


def _symbolic(*sizes) -> bool:
    return any(isinstance(s, torch.SymInt) for s in sizes)


def _im2col_gemm(xq_pad, wt, n, rows, w, kh, kw, cin, d):
    """The (n * rows * w, Cout padded) int32 product of one band: the
    im2col of ``xq_pad`` (already sliced to the band's rows plus the
    kernel's reach; columns ordered (kh, kw, cin)) times ``wt.t()``, with K
    zero-padded to ``wt``'s and at least 17 rows."""
    k = kh * kw * cin
    m = n * rows * w
    taps = [xq_pad[:, i * d : i * d + rows, j * d : j * d + w, :] for i in range(kh) for j in range(kw)]
    a = (torch.stack(taps, dim=3) if len(taps) > 1 else taps[0]).reshape(m, k)
    symbolic = _symbolic(m)
    extra = torch.sym_max(17 - m, 0) if symbolic else max(17 - m, 0)
    if symbolic or extra or wt.shape[1] != k:
        a = F.pad(a, (0, wt.shape[1] - k, 0, extra))
    return torch._int_mm(a, wt.t())[:m]


def _conv_int8(
    qlayer: dict, x: torch.Tensor, dilation: int = 1, name: str = "", hook: Optional[AccHook] = None
) -> torch.Tensor:
    """Quantize the NHWC float input with the calibrated scale, convolve the
    codes exactly (im2col + ``torch._int_mm``, SAME padding, ``dilation``),
    rescale: (N, H, W, Cout) float32. ``qlayer`` carries ``wt``
    (:func:`gemm_operand`) beside the qtree's entries; ``hook`` (checks
    only: it keeps every band's result) gets the int32 accumulator."""
    xq = torch.clamp(torch.round(x / qlayer["s_in"]), -127, 127).to(torch.int8)
    wq, wt = qlayer["wq"], qlayer["wt"]
    cout, cin, kh, kw = wq.shape
    pad = dilation * (kh // 2)
    xq_pad = F.pad(xq, (0, 0, pad, pad, pad, pad))
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    scale, bias = qlayer["rescale"], qlayer["bias"]
    if _symbolic(n, h, w):
        acc = _im2col_gemm(xq_pad, wt, n, h, w, kh, kw, cin, dilation)[:, :cout]
        return (acc.to(torch.float32) * scale + bias).view(n, h, w, cout)
    out = torch.empty((n, h, w, cout), dtype=torch.float32, device=x.device)
    rows = band_rows(n, h, w, kh * kw * cin)
    accs = []
    for r0 in range(0, h, rows):
        rb = min(rows, h - r0)
        band = xq_pad[:, r0 : r0 + rb + 2 * pad]
        acc = _im2col_gemm(band, wt, n, rb, w, kh, kw, cin, dilation)[:, :cout]
        if hook is not None:
            accs.append(acc.view(n, rb, w, cout))
        out[:, r0 : r0 + rb] = (acc.to(torch.float32) * scale + bias).view(n, rb, w, cout)
    if hook is not None:
        hook(name, torch.cat(accs, dim=1))
    return out


def _conv_f32(layer: dict, x: torch.Tensor, dilation: int = 1, name: str = "") -> torch.Tensor:
    """The float convolution over an NHWC input (SAME padding)."""
    k = layer["weight"].shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), layer["weight"], layer["bias"], padding=dilation * (k // 2), dilation=dilation)
    return y.permute(0, 2, 3, 1)


def _forward(layers, x, wb, ce, gc, conv, observe=None) -> torch.Tensor:
    """WaterNet's topology over a per-layer ``conv`` primitive, NHWC.
    ``observe(branch, i, inp)`` (calibration) sees every conv input."""

    def run(branch, inp, acts):
        for i, act in enumerate(acts):
            if observe is not None:
                observe(branch, i, inp)
            out = conv(layers[branch][i], inp, 1, f"{branch}/{i}")
            inp = torch.sigmoid(out) if act == "sigmoid" else torch.relu(out)
        return inp

    cm = run("cmg", torch.cat([x, wb, ce, gc], dim=-1), _CMG_ACTS)
    fused = 0.0
    for name, var, sl in (("wb_refiner", wb, 0), ("ce_refiner", ce, 1), ("gc_refiner", gc, 2)):
        refined = run(name, torch.cat([x, var], dim=-1), _REFINER_ACTS)
        fused = fused + refined * cm[..., sl : sl + 1]
    return fused.to(torch.float32)


def _can_forward(layers, x, conv, observe=None) -> torch.Tensor:
    """The CAN student's topology over a per-layer ``conv`` primitive."""
    h = x
    dilations = can_dilations(len(layers) - 1)
    for i, d in enumerate(dilations):
        if observe is not None:
            observe("can", i, h)
        h = F.leaky_relu(conv(layers[i], h, d, f"can/{i}"), negative_slope=0.2)
    if observe is not None:
        observe("can", len(dilations), h)
    delta = conv(layers[-1], h, 1, f"can/{len(dilations)}")
    return x.to(torch.float32) + delta.to(torch.float32)


def _layer_tree(sd: dict) -> Dict[str, List[dict]]:
    """WaterNet state_dict -> {branch: [{weight, bias}, ...]}."""
    return {
        name: [{"weight": sd[f"{name}.conv{i + 1}.weight"], "bias": sd[f"{name}.conv{i + 1}.bias"]} for i in range(n)]
        for name, n in _BRANCHES
    }


def _can_layers(sd: dict) -> List[dict]:
    """CAN state_dict -> ordered [{weight, bias}, ...] (the last is the head)."""
    n = len({k.split(".")[1] for k in sd})
    return [{"weight": sd[f"layers.{i}.weight"], "bias": sd[f"layers.{i}.bias"]} for i in range(n)]


def _on(sd: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.float32) for k, v in sd.items()}


def _as_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32) if not torch.is_tensor(a) else a).to(device, torch.float32)


def float_forward(params: dict, x, wb, ce, gc) -> torch.Tensor:
    """The fp32 forward over the functional topology (``params`` a WaterNet
    state_dict on the inputs' device)."""
    return _forward(_layer_tree(params), x, wb, ce, gc, _conv_f32)


@torch.no_grad()
def calibration_stats(params: dict, batches: Sequence[Tuple], device="cpu") -> Dict[str, float]:
    """absmax of every conv input over the calibration batches ((x, wb, ce,
    gc) float arrays in [0, 1]), from the float forward on ``device``. Every
    batch is run before anything is read back."""
    layers = _layer_tree(_on(params, device))
    pending = []
    for batch in batches:
        stats = {}

        def observe(branch, i, inp, stats=stats):
            stats[f"{branch}/{i}"] = inp.abs().max()

        _forward(layers, *(_as_tensor(a, device) for a in batch), _conv_f32, observe=observe)
        pending.append(stats)
    return _merge_max(pending)


def _merge_max(pending: list) -> Dict[str, float]:
    agg: Dict[str, float] = {}
    for stats in pending:
        for k, v in stats.items():
            agg[k] = max(agg.get(k, 0.0), float(v))
    return agg


def default_calibration_inputs(n: int = 8, hw: int = 112, seed: int = 0):
    """Synthetic calibration batch: the raw frames and their WB/GC/CLAHE
    variants (cv2, on the host), float32 in [0, 1], as ``[(x, wb, he,
    gc)]``: the input distribution the model sees at inference."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.ops.transform import transform_np

    data = SyntheticPairs(n, hw, hw, seed=seed)
    xs, wbs, hes, gcs = [], [], [], []
    for i in range(n):
        raw, _ = data.load_pair(i)
        wb, gc, he = transform_np(raw)
        xs.append(raw)
        wbs.append(wb)
        hes.append(he)
        gcs.append(gc)

    def f(a):
        return np.stack(a).astype(np.float32) / 255.0

    return [(f(xs), f(wbs), f(hes), f(gcs))]


def _quantize_layers(convs: List[dict], stats: Dict[str, float], branch: str) -> List[dict]:
    """One branch's float layers -> int8 layer dicts, with input scales read
    from ``stats`` under ``{branch}/{i}``. The codes and scales are computed
    in numpy on the HWIO kernel, as the JAX package does."""
    qconvs = []
    for i, layer in enumerate(convs):
        w = np.ascontiguousarray(torch.as_tensor(layer["weight"]).detach().cpu().numpy().astype(np.float32).transpose(2, 3, 1, 0))
        s_w = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / 127.0
        s_w = np.maximum(s_w, 1e-12)
        wq = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
        s_in = max(stats[f"{branch}/{i}"], 1e-12) / 127.0
        qconvs.append({
            "wq": torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 2, 0, 1))),
            "bias": torch.as_tensor(layer["bias"]).detach().cpu().to(torch.float32).clone(),
            "s_in": torch.tensor(np.float32(s_in)),
            "rescale": torch.from_numpy(np.asarray(s_in * s_w, np.float32)),
        })
    return qconvs


def quantize_waternet(params: dict, calib_batches=None, device="cpu") -> dict:
    """WaterNet state_dict -> int8 qtree ``{branch: [{wq, bias, s_in,
    rescale}, ...]}`` (CPU tensors), calibrated on ``calib_batches`` (or
    :func:`default_calibration_inputs`) on ``device``."""
    if calib_batches is None:
        calib_batches = default_calibration_inputs()
    stats = calibration_stats(params, calib_batches, device=device)
    return {branch: _quantize_layers(convs, stats, branch) for branch, convs in _layer_tree(params).items()}


def _device_layers(layers: List[dict], device) -> List[dict]:
    out = []
    for q in layers:
        d = {k: v.to(device) for k, v in q.items() if k != "wt"}
        d["wt"] = gemm_operand(d["wq"])
        out.append(d)
    return out


class QuantWaterNet:
    """A WaterNet qtree placed on ``device``: ``model(x, wb, ce, gc)`` on
    four (N, H, W, 3) float tensors in [0, 1] -> (N, H, W, 3) float32,
    through the int8 convolutions. ``qtree`` stays the CPU original;
    ``acc_hook`` (an :data:`AccHook`, None by default) reads every conv's
    accumulator."""

    def __init__(self, qtree: dict, device, acc_hook: Optional[AccHook] = None):
        self.qtree, self.device, self.acc_hook = qtree, torch.device(device), acc_hook
        self.layers = {b: _device_layers(qtree[b], self.device) for b, _ in _BRANCHES}

    @torch.no_grad()
    def __call__(self, x, wb, ce, gc) -> torch.Tensor:
        return _forward(self.layers, x, wb, ce, gc, functools.partial(_conv_int8, hook=self.acc_hook))


def quant_forward(qtree: dict, x, wb, ce, gc, acc_hook: Optional[AccHook] = None) -> torch.Tensor:
    """The int8 WaterNet forward on the inputs' device."""
    return QuantWaterNet(qtree, x.device, acc_hook)(x, wb, ce, gc)


# ----------------------------------------------------------------------
# The CAN student: the fast tier's int8 forward, the same scheme over its
# dilated stack. Its hidden activations are signed (LeakyReLU) and
# unbounded, so calibration on representative frames pins the scales.
# ----------------------------------------------------------------------


def can_float_forward(params: dict, x) -> torch.Tensor:
    """The fp32 forward over the functional CAN topology (``params`` a
    ``CANStudent`` state_dict on the input's device)."""
    return _can_forward(_can_layers(params), x, _conv_f32)


@torch.no_grad()
def can_calibration_stats(params: dict, batches: Sequence, device="cpu") -> Dict[str, float]:
    """absmax of every student conv input over raw-RGB calibration batches
    (float arrays in [0, 1])."""
    layers = _can_layers(_on(params, device))
    pending = []
    for x in batches:
        stats = {}

        def observe(branch, i, inp, stats=stats):
            stats[f"{branch}/{i}"] = inp.abs().max()

        _can_forward(layers, _as_tensor(x, device), _conv_f32, observe=observe)
        pending.append(stats)
    return _merge_max(pending)


def default_can_calibration_inputs(n: int = 8, hw: int = 112, seed: int = 0):
    """Synthetic raw-RGB calibration frames in [0, 1]: the student's whole
    input distribution (it consumes no enhanced variants)."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs

    data = SyntheticPairs(n, hw, hw, seed=seed)
    raw = np.stack([data.load_pair(i)[0] for i in range(n)])
    return [raw.astype(np.float32) / 255.0]


def quantize_can(params: dict, calib_batches=None, device="cpu") -> dict:
    """Student state_dict -> int8 qtree ``{"can": [{wq, bias, s_in,
    rescale}, ...]}`` (deterministic for a given params and calibration)."""
    if calib_batches is None:
        calib_batches = default_can_calibration_inputs()
    stats = can_calibration_stats(params, calib_batches, device=device)
    return {"can": _quantize_layers(_can_layers(params), stats, "can")}


class QuantCAN:
    """A CAN qtree placed on ``device``: ``model(x)`` like ``CANStudent``
    (``acc_hook`` as :class:`QuantWaterNet`'s)."""

    def __init__(self, qtree: dict, device, acc_hook: Optional[AccHook] = None):
        self.qtree, self.device, self.acc_hook = qtree, torch.device(device), acc_hook
        self.layers = _device_layers(qtree["can"], self.device)

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        return _can_forward(self.layers, x, functools.partial(_conv_int8, hook=self.acc_hook))


def can_quant_forward(qtree: dict, x, acc_hook: Optional[AccHook] = None) -> torch.Tensor:
    """The student's int8 forward on the input's device."""
    return QuantCAN(qtree, x.device, acc_hook)(x)


def is_qtree(params) -> bool:
    """True for a qtree of :func:`quantize_waternet` or :func:`quantize_can`."""
    return isinstance(params, dict) and bool(params) and all(
        isinstance(v, list) and v and isinstance(v[0], dict) and "wq" in v[0] for v in params.values()
    )
