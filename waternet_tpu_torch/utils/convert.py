"""Weights between the JAX package's param trees and the port's state_dicts.

WaterNet: the JAX tree is ``{"params": {module: {"Conv_i": {"kernel",
"bias"}}}}`` with HWIO kernels; the port's (and the reference's) state_dict
keys are ``{module}.conv{i+1}.{weight,bias}`` with OIHW weights. VGG19: the
JAX tree is ``{"params": {"Conv_i": ...}}``, the port's keys torchvision's
``features.{idx}.{weight,bias}``. The CAN student: the JAX tree is
``{"params": {"Conv_i": ...}}`` (the dilated stages, then the 1x1 head),
the port's keys ``layers.{i}.{weight,bias}``. Pure relayout: no value changes, so the
round trips are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from waternet_tpu_torch.utils.checkpoint import unflatten

# Module name -> conv count (the reference's net.py layout).
WATERNET_MODULES = {"cmg": 8, "wb_refiner": 3, "ce_refiner": 3, "gc_refiner": 3}


def _nested(params: dict) -> dict:
    """Accept the nested tree or its flat ``a/b/c`` npz keys; return the
    per-module dict (the content of ``params["params"]``)."""
    if any("/" in k for k in params):
        params = unflatten(params)
    return params["params"] if "params" in params else params


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX WaterNet params (numpy arrays, nested or flat keys) -> state_dict."""
    tree = _nested(params)
    sd = {}
    for mod, n_convs in WATERNET_MODULES.items():
        for i in range(n_convs):
            conv = tree[mod][f"Conv_{i}"]
            kernel = np.asarray(conv["kernel"], dtype=np.float32)
            sd[f"{mod}.conv{i + 1}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
            )
            sd[f"{mod}.conv{i + 1}.bias"] = torch.from_numpy(
                np.asarray(conv["bias"], dtype=np.float32).copy()
            )
    return sd


def jax_from_state_dict(sd: dict) -> dict:
    """state_dict -> the JAX package's nested param tree, numpy arrays."""
    tree: dict = {}
    for mod, n_convs in WATERNET_MODULES.items():
        tree[mod] = {}
        for i in range(n_convs):
            w = sd[f"{mod}.conv{i + 1}.weight"].detach().cpu().numpy()
            b = sd[f"{mod}.conv{i + 1}.bias"].detach().cpu().numpy()
            tree[mod][f"Conv_{i}"] = {
                "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                "bias": b.copy(),
            }
    return {"params": tree}


def is_can_tree(params: dict) -> bool:
    """True for a CAN student's JAX tree (nested or flat keys): every conv
    directly under ``params`` as ``Conv_i``, with a 3-channel input first
    layer (VGG19's trees share the naming, not the 3-channel 1x1 head)."""
    tree = _nested(params)
    if not tree or any(not k.startswith("Conv_") for k in tree):
        return False
    last = tree[f"Conv_{len(tree) - 1}"].get("kernel")
    return last is not None and tuple(np.shape(last))[:2] == (1, 1) and np.shape(last)[-1] == 3


def can_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX CAN student params (``params/Conv_i/{kernel,bias}``, HWIO; nested
    or flat keys) -> the port's ``CANStudent`` state_dict (OIHW)."""
    tree = _nested(params)
    sd = {}
    for i in range(len(tree)):
        conv = tree[f"Conv_{i}"]
        kernel = np.asarray(conv["kernel"], dtype=np.float32)
        sd[f"layers.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"layers.{i}.bias"] = torch.from_numpy(np.asarray(conv["bias"], dtype=np.float32).copy())
    return sd


def jax_from_can_state_dict(sd: dict) -> dict:
    """``CANStudent`` state_dict -> the JAX package's nested param tree."""
    n = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    tree = {}
    for i in range(n):
        w = sd[f"layers.{i}.weight"].detach().cpu().numpy()
        tree[f"Conv_{i}"] = {
            "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "bias": sd[f"layers.{i}.bias"].detach().cpu().numpy().copy(),
        }
    return {"params": tree}


def qtree_from_jax(qtree: dict) -> dict:
    """A JAX int8 qtree (``models/quant.py``'s ``{branch: [{wq, bias, s_in,
    rescale}]}``, HWIO ``wq``; numpy or jax arrays) -> the port's (OIHW
    int8 ``wq``, float32 tensors). Pure relayout."""
    return {
        branch: [
            {
                "wq": torch.from_numpy(np.ascontiguousarray(np.asarray(q["wq"], np.int8).transpose(3, 2, 0, 1))),
                "bias": torch.from_numpy(np.asarray(q["bias"], np.float32).copy()),
                "s_in": torch.tensor(np.float32(q["s_in"])),
                "rescale": torch.from_numpy(np.asarray(q["rescale"], np.float32).copy()),
            }
            for q in layers
        ]
        for branch, layers in qtree.items()
    }


def vgg_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX VGG19 params (``params/Conv_i/{kernel,bias}``, HWIO; nested or
    flat keys) -> the port's VGG19Features state_dict (OIHW)."""
    from waternet_tpu_torch.models.vgg import conv_indices

    tree = _nested(params)
    sd = {}
    for i, idx in enumerate(conv_indices()):
        conv = tree[f"Conv_{i}"]
        kernel = np.asarray(conv["kernel"], dtype=np.float32)
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
        )
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            np.asarray(conv["bias"], dtype=np.float32).copy()
        )
    return sd


def train_state_from_jax(params, opt_state, step, config=None) -> dict:
    """The JAX package's train state -> the port's, in the format of
    :meth:`waternet_tpu_torch.training.trainer.TrainingEngine.train_state`.

    Takes numpy arrays, as ``jax.device_get(engine.state)`` returns them:
    ``params``, the optax ``opt_state`` of ``optax.adam`` over the staircase
    schedule (a ``ScaleByAdamState`` with ``count``, ``mu`` and ``nu``, and
    the schedule's state with its ``count``) and ``step``. ``mu``/``nu``
    become Adam's ``exp_avg``/``exp_avg_sq``, laid out like the parameters
    (HWIO -> OIHW, as :func:`state_dict_from_jax`; no value changes), with
    Adam's ``step`` from the Adam count; the ``LambdaLR`` is put at the
    schedule's count, its learning rate what an uninterrupted run would
    have there. ``config`` (a ``TrainConfig``; the default one if None)
    gives the schedule's lr, lr_step and lr_gamma."""
    from waternet_tpu_torch.models import WaterNet
    from waternet_tpu_torch.training.trainer import TrainConfig, make_optimizer

    adam = next(s for s in opt_state if hasattr(s, "mu"))
    sched_count = next((s.count for s in opt_state if hasattr(s, "count") and not hasattr(s, "mu")), adam.count)
    model = WaterNet()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    opt, sched = make_optimizer(model.parameters(), config or TrainConfig())
    mu, nu = state_dict_from_jax(adam.mu), state_dict_from_jax(adam.nu)
    for name, p in model.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(adam.count), dtype=torch.float32),
            "exp_avg": mu[name],
            "exp_avg_sq": nu[name],
        }
    k = int(sched_count)
    lrs = [base * lam(k) for base, lam in zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(opt.param_groups, lrs):
        group["lr"] = lr
    # The scheduler's own bookkeeping after k steps past its initial one.
    sched.last_epoch, sched._step_count, sched._last_lr = k, k + 1, lrs
    return {
        "model": model.state_dict(),
        "optimizer": opt.state_dict(),
        "scheduler": sched.state_dict(),
        "step": int(step),
    }
