"""Training: ``TrainingEngine.train_epoch_cached`` epoch after epoch over a
device cache, as ``train --device-cache`` runs it.

Mix keys: ``pairs`` (seeded raw/reference pairs), ``height``, ``width``,
``batch``, ``codec``, ``precache_histeq``, ``setup_steps``.

Set-up builds the one engine, caches the pairs and trains the epoch's
first ``setup_steps`` steps through ``train_epoch_cached`` itself, which
warms every shape the window runs; the window then continues that epoch
from the next batch on the same engine. The first steps' losses, the
first gradient (from Adam's first moment after step 1) and the
parameters' change are what the reference follows. The window ends at
the first step boundary past ``--seconds``, where the driver's fetch
waits for every dispatched step: ``train_images_per_s`` is their images
over the window's length.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import arch as archs
from perfbench.reference import compare
from perfbench.reference import train as train_ref
from perfbench.traffic import images


class _Pairs:
    """The seeded pairs as the trainer's dataset interface."""

    def __init__(self, raw: np.ndarray, ref: np.ndarray):
        self.raw, self.ref = raw, ref

    def __len__(self) -> int:
        return len(self.raw)

    def load_pair(self, idx: int):
        return self.raw[idx], self.ref[idx]


class _Hook:
    """The epoch driver asks ``preemption.requested`` once after each
    dispatched step: the benchmark's step-boundary hook."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def requested(self) -> bool:
        return self.fn()


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def setup(run) -> dict:
    from waternet_tpu_torch.resilience.control import EpochControl
    from waternet_tpu_torch.resilience.preemption import Preempted
    from waternet_tpu_torch.training.trainer import TrainConfig, TrainingEngine

    mix, cfg = run.mix, run.config
    arch = archs.load(cfg)
    params = arch.make_params(cfg, run.generator("weights"), run.device)
    vgg = arch.make_vgg(run.generator("vgg"), run.device)
    raw, ref = images.pairs(run.generator("pairs"), mix["pairs"], mix["height"], mix["width"], run.device)
    raw, ref = raw.cpu().numpy(), ref.cpu().numpy()
    run.mark("weights_and_pairs")
    config = TrainConfig(
        batch_size=mix["batch"], im_height=mix["height"], im_width=mix["width"],
        precision=cfg["precision"], seed=run.seed, cache_codec=mix["codec"],
        precache_histeq=mix["precache_histeq"], perceptual_weight=cfg["loss"]["perceptual_weight"],
    )
    engine = TrainingEngine(config, params={k: v.cpu() for k, v in params.items()},
                            vgg_params={k: v.cpu() for k, v in vgg.items()}, device=run.device)
    run.mark("engine")
    engine.cache_dataset(_Pairs(raw, ref), np.arange(mix["pairs"]))
    run.mark("cache")

    steps = mix["setup_steps"]
    flag = {"stop": False}
    grads = {}

    def after_step(next_batch, _partial):
        if next_batch == 1:
            beta1 = engine.optimizer.param_groups[0]["betas"][0]
            # Adam's first moment after one step is (1 - beta1) * gradient; an
            # optimizer that kept no state moved nothing.
            grads.update({n: (engine.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - beta1)).cpu()
                          for n, p in engine.model.named_parameters()})
        if next_batch == steps - 1:
            flag["stop"] = True

    control = EpochControl(preemption=_Hook(lambda: flag["stop"]), checkpoint_cb=after_step, every_steps=1)
    try:
        engine.train_epoch_cached(0, control=control)
        raise RuntimeError("the set-up steps ran the whole epoch")
    except Preempted as p:
        if p.next_batch != steps:
            raise RuntimeError(f"set-up stopped before batch {p.next_batch}, not {steps}") from None
        fetched = p.partial
    run.mark("first_steps")
    current = dict(engine.model.named_parameters())
    prog = {
        "loss": [m["loss"] for m in fetched],
        "mse": [m["mse"] for m in fetched],
        "perceptual": [m["perceptual_loss"] for m in fetched],
        "grads": grads,
        "grad_norms": _norms(grads),
        "change_norms": _norms({n: current[n].detach() - params[n] for n in current}),
    }
    return {"engine": engine, "params": params, "vgg": vgg, "raw": raw, "ref": ref, "prog": prog,
            "carry": fetched}


def window(run, state) -> dict:
    from waternet_tpu_torch.resilience.control import EpochControl
    from waternet_tpu_torch.resilience.preemption import Preempted

    mix, engine = run.mix, state["engine"]
    n_batches = -(-mix["pairs"] // mix["batch"])
    shape = (mix["batch"], mix["height"], mix["width"])
    run.host.update(step_shape=shape, decode_shape=(2 * mix["batch"], mix["height"], mix["width"]))
    count = {"steps": 0, "phase": "window"}

    def at_boundary() -> bool:
        count["steps"] += 1
        if count["phase"] == "window":
            if not run.window_over():
                return False
            if not run.trace:
                return True
            run.sync()
            t1 = time.perf_counter()
            run.end_window(t1)
            run.host.update(steps=count["steps"], window_s=t1 - t0)
            count.update(phase="profile", mark=count["steps"])
            run.start_profile()
            return False
        if not run.profile_over(count["steps"] - count["mark"]):
            return False
        run.stop_profile(count["steps"] - count["mark"])
        return True

    control = EpochControl(preemption=_Hook(at_boundary))
    epoch, start, carry, done = 0, mix["setup_steps"], state.pop("carry"), 0
    t0 = run.start_window()
    while True:
        try:
            engine.train_epoch_cached(epoch, start_batch=start, control=control, carry=carry)
        except Preempted as p:
            done += p.next_batch - start
            break
        done += n_batches - start
        epoch, start, carry = epoch + 1, 0, None
    t1 = time.perf_counter()
    if not run.trace:
        run.end_window(t1)
        run.host.update(steps=done, window_s=t1 - t0)
    images_done = run.host["steps"] * mix["batch"]
    return {"attempted": images_done, "failed": 0,
            "metrics": {"train_images_per_s": images_done / run.host["window_s"]}}


def close(run, state) -> None:
    state.pop("engine", None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def check(run, state) -> dict:
    """The set-up steps' losses, first gradient and change against the
    reference following the same steps in float32."""
    mix = run.mix
    ref = train_ref.follow(state["params"], state["vgg"], run.config, state["raw"], state["ref"], run.seed,
                           mix["batch"], mix["setup_steps"], run.device,
                           perceptual_weight=run.config["loss"]["perceptual_weight"])
    return compare.train_numbers(state["prog"], ref)
