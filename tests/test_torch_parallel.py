"""The port's spatial and data sharding against the JAX package's, on the CPU.

The JAX side runs on the conftest's 8 forced host devices; the port runs
its shards on ``["cpu"] * n`` (the rehearsal layout: the same windows,
copies and crops on one device). Bounds: the spatial forward within
``atol 2e-5`` of JAX's at 2, 4 and 8 shards (the fp32 forward parity bound
of ``tests/test_convert.py``); the sharded engines' uint8 answers within
one level of JAX's sharded engines (the engines' bound,
``tests/test_torch_engine.py``); a spatial train step within float
tolerance of the unsharded port step (the same loss on the same image,
the forward computed in windows).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waternet_tpu.inference_engine import InferenceEngine as JaxEngine
from waternet_tpu.models import WaterNet as JaxWaterNet
from waternet_tpu.parallel import mesh as jax_mesh
from waternet_tpu.parallel import spatial as jax_spatial
from waternet_tpu.serving.batcher import fit_ladder_to_engine as jax_fit_ladder
from waternet_tpu.serving.bucketing import BucketLadder as JaxLadder
from waternet_tpu_torch.inference_engine import InferenceEngine
from waternet_tpu_torch.models import WaterNet
from waternet_tpu_torch.models import quant
from waternet_tpu_torch.parallel import mesh
from waternet_tpu_torch.parallel.spatial import HALO, spatial_sharded_apply
from waternet_tpu_torch.serving.batcher import fit_ladder_to_engine
from waternet_tpu_torch.serving.bucketing import BucketLadder
from waternet_tpu_torch.serving.replicas import resolve_replicas
from waternet_tpu_torch.utils.convert import state_dict_from_jax

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def params():
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return JaxWaterNet().init(jax.random.PRNGKey(0), x, x, x, x)


@pytest.fixture(scope="module")
def model(params):
    m = WaterNet()
    m.load_state_dict(state_dict_from_jax(params))
    return m.eval()


def planes(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.random(shape, dtype=np.float32) for _ in range(4)]


def test_halo_is_the_jax_packages():
    assert HALO == jax_spatial.HALO == 13


@pytest.mark.parametrize("n_data,n_spatial", [(None, 1), (2, 4), (4, 2), (None, 2), (8, 1)])
def test_make_mesh_shapes_equal_jax(n_data, n_spatial):
    got = mesh.make_mesh(n_data, n_spatial, [CPU] * 8)
    want = jax_mesh.make_mesh(n_data, n_spatial)
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert got.spatial_devices() == [CPU] * n_spatial


@pytest.mark.parametrize("n_data,n_spatial,match", [(None, 3, "not divisible"), (4, 4, "needs 16 devices")])
def test_make_mesh_errors_equal_jax(n_data, n_spatial, match):
    with pytest.raises(ValueError, match=match) as got:
        mesh.make_mesh(n_data, n_spatial, [CPU] * 8)
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(n_data, n_spatial)
    assert str(got.value) == str(want.value)


def test_make_mesh_default_takes_cuda_devices_and_raises_without_them(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="only 0 are available"):
        mesh.make_mesh(1, 2)


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (1, 3), (7, 2), (3, 8)])
def test_pad_to_multiple_equals_jax(n, multiple):
    arr = np.arange(n * 6).reshape(n, 2, 3)
    got, got_n = mesh.pad_to_multiple(arr, multiple)
    want, want_n = jax_mesh.pad_to_multiple(arr, multiple)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards,shape", [(2, (2, 64, 40, 3)), (4, (1, 128, 48, 3)), (8, (1, 208, 32, 3))])
def test_spatial_forward_matches_jax(params, model, n_shards, shape):
    """Two edge shards (n=2), interior shards (4, 8): within atol 2e-5 of
    JAX's ``shard_map`` forward on the same weights."""
    x = planes(shape, n_shards)
    want = np.asarray(jax_spatial.spatial_sharded_apply(
        JaxWaterNet(), jax_mesh.make_mesh(n_data=8 // n_shards, n_spatial=n_shards))(
        params, *(jnp.asarray(a) for a in x)))
    fn = spatial_sharded_apply(model, mesh.make_mesh(1, n_shards, [CPU] * n_shards))
    with torch.no_grad():
        got = fn(*(torch.from_numpy(a) for a in x)).numpy()
        unsharded = model(*(torch.from_numpy(a) for a in x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, unsharded, rtol=0, atol=2e-5)


def test_spatial_slab_of_26_rows_accepted_and_25_refused(params, model):
    fn = spatial_sharded_apply(model, mesh.make_mesh(1, 2, [CPU] * 2))
    x = planes((1, 52, 40, 3), 3)
    want = np.asarray(jax_spatial.spatial_sharded_apply(JaxWaterNet(), jax_mesh.make_mesh(4, 2))(
        params, *(jnp.asarray(a) for a in x)))
    with torch.no_grad():
        got = fn(*(torch.from_numpy(a) for a in x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match=r"spatial slab of 25 rows < 2\*HALO=26"):
        fn(*(torch.from_numpy(a[:, :50]) for a in x))
    with pytest.raises(ValueError, match="not divisible by spatial_shards=2"):
        fn(*(torch.from_numpy(a[:, :51]) for a in x))


def test_int8_through_the_spatial_path(params):
    """The int8 forward (pointwise quantize/rescale around exact integer
    convolutions) windowed over 2 shards equals the unsharded int8
    forward on the same qtree (narrow: the CPU's int8 products are slow)."""
    calib = [tuple(planes((1, 32, 32, 3), 7))]
    qtree = quant.quantize_waternet(state_dict_from_jax(params), calib, device="cpu")
    qmodel = quant.QuantWaterNet(qtree, CPU)
    x = [torch.from_numpy(a) for a in planes((1, 52, 8, 3), 4)]
    got = spatial_sharded_apply(qmodel, mesh.make_mesh(1, 2, [CPU] * 2))(*x)
    np.testing.assert_allclose(got.numpy(), qmodel(*x).numpy(), rtol=0, atol=2e-5)


def frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([60 + 40 * np.sin(xx / 9 + c) + 30 * np.cos(yy / 6 + c) + 40 * c for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 10, (n, h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["spatial", "data"])
def test_sharded_engines_within_one_level_of_jax(params, kind):
    """Host preprocessing (cv2 on both sides); 3 frames, so the data-sharded
    engines pad one frame and crop it back."""
    kw = {"spatial_shards": 2} if kind == "spatial" else {"data_shards": 2}
    batch = frames(3, 64, 48, 5)
    want = JaxEngine(params=params, **kw).enhance(batch)
    engine = InferenceEngine(params=state_dict_from_jax(params), device="cpu", **kw)
    got = engine.enhance(batch)
    assert got.shape == want.shape == batch.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert engine.mesh.shape == {"data": kw.get("data_shards", 1), "spatial": kw.get("spatial_shards", 1)}


@pytest.mark.parametrize("kw", [{"spatial_shards": 2}, {"data_shards": 2}])
def test_sharded_device_preprocess_engine_within_one_level_of_unsharded(params, kw):
    sd = state_dict_from_jax(params)
    batch = frames(3, 64, 48, 6)
    want = InferenceEngine(params=sd, device="cpu", device_preprocess=True).enhance(batch)
    got = InferenceEngine(params=sd, device="cpu", device_preprocess=True, **kw).enhance(batch)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_engine_sharding_validation(params):
    sd = state_dict_from_jax(params)
    with pytest.raises(ValueError, match="mutually exclusive"):
        InferenceEngine(params=sd, device="cpu", spatial_shards=2, data_shards=2)
    with pytest.raises(ValueError, match="needs 3 devices, but only 2"):
        InferenceEngine(params=sd, device="cpu", spatial_shards=3, devices=[CPU] * 2)
    eng = InferenceEngine(params=sd, device="cpu", spatial_shards=4)
    with pytest.raises(ValueError, match="slab"):
        eng.enhance(frames(1, 96, 40, 0))
    with pytest.raises(ValueError, match="divisible"):
        eng.enhance(frames(1, 90, 40, 0))


@pytest.mark.parametrize("shards", [{"spatial_shards": 2}, {"spatial_shards": 4}, {"data_shards": 2},
                                    {"spatial_shards": 1}])
def test_fit_ladder_to_engine_equals_jax(shards):
    buckets = [(40, 64), (51, 51), (97, 130), (130, 97)]
    engine = types.SimpleNamespace(**{"spatial_shards": 1, "data_shards": 1, **shards})
    got = fit_ladder_to_engine(BucketLadder(buckets), engine)
    want = jax_fit_ladder(JaxLadder(buckets), engine)
    assert list(got) == list(want)


def test_sharded_engine_serves_as_one_replica(params):
    from waternet_tpu_torch.serving import DynamicBatcher, derive_buckets
    from waternet_tpu_torch.serving.replicas import ReplicaPool

    sd = state_dict_from_jax(params)
    data = InferenceEngine(params=sd, device="cpu", data_shards=2)
    assert resolve_replicas("auto", data) == 1
    with pytest.raises(ValueError, match="ONE replica"):
        resolve_replicas("2", data)
    with pytest.raises(ValueError, match="ONE replica"):
        ReplicaPool(data, BucketLadder([(32, 32)]), [2], n_replicas=2)
    images = [frames(1, h, w, i)[0] for i, (h, w) in enumerate([(40, 36), (33, 50), (52, 40)])]
    ladder = derive_buckets([im.shape[:2] for im in images], max_buckets=1)
    batcher = DynamicBatcher(data, ladder, max_batch=3)
    try:
        assert batcher.max_batch == 4  # rounded up to a multiple of the data shards
        outs = batcher.map_ordered(images)
    finally:
        batcher.close()
    ref = DynamicBatcher(InferenceEngine(params=sd, device="cpu"), ladder, max_batch=4)
    try:
        want = ref.map_ordered(images)
    finally:
        ref.close()
    for a, b in zip(outs, want):
        assert a.shape == b.shape and np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_spatial_train_step_matches_the_unsharded_step():
    """One fp32 step (MSE; SSIM and PSNR as metrics): the sharded forward
    and backward (2 shards) against the unsharded step from the same init
    and batch: metrics within rel 1e-5, updated parameters within 1e-5 (1%
    of Adam's first step, lr 1e-3: float noise in a gradient moves its
    normalized update by as much)."""
    from waternet_tpu_torch.data.synthetic import SyntheticPairs
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine, step_generator

    data = SyntheticPairs(4, 56, 40, seed=0)
    raw, ref = next(data.batches(np.arange(4), 4, shuffle=False))
    results = {}
    for shards in (1, 2):
        cfg = TrainConfig(batch_size=4, im_height=56, im_width=40, precision="fp32", perceptual_weight=0.0,
                          spatial_shards=shards)
        engine = TrainingEngine(cfg, device="cpu")
        assert engine.devices == [CPU] * shards
        m = engine.train_step(torch.from_numpy(raw), torch.from_numpy(ref), step_generator(0, 0, 0), 4)
        results[shards] = ({k: v.item() for k, v in m.items()}, engine.model.state_dict())
    (m1, p1), (m2, p2) = results[1], results[2]
    for k in m1:
        assert m2[k] == pytest.approx(m1[k], rel=1e-5), k
    assert max((p1[k] - p2[k]).abs().max().item() for k in p1) < 1e-5


def test_spatial_train_config_guards():
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine

    with pytest.raises(ValueError, match="data parallelism only"):
        TrainConfig(distill=True, spatial_shards=2).check_ported()
    with pytest.raises(ValueError, match="needs as many devices"):
        TrainingEngine(TrainConfig(spatial_shards=2), device="cpu", devices=[CPU] * 3)
