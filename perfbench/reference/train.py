"""WaterNet's training step in plain float32, followed for the first steps
of an epoch: the batches the cache serves, their augmentation, the
classical inputs, the forward, the loss ``0.05 * perceptual + mse_255``
and Adam (lr 1e-3, betas 0.9 / 0.999, eps 1e-8).

The epoch's order, each step's augmentation draws and the cache's decoded
pixels are worked out here again from the seed and the raw images: the
order is the Philox shuffle keyed ``seed + 7919 * epoch``; step ``k``'s
draws come from a CPU ``torch.Generator`` seeded from
``SeedSequence([seed + 1, epoch, k])`` as hflip, vflip and rotate flags
(uniform < 0.5) and a rotation in {0, 1, 2, 3}, applied in that order.
Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import codec, nets, preprocess

PERCEPTUAL_WEIGHT = 0.05
LR, BETAS, EPS = 1e-3, (0.9, 0.999), 1e-8


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n)
    np.random.Generator(np.random.Philox(key=seed + 7919 * epoch)).shuffle(order)
    return order


def step_draws(seed: int, epoch: int, step: int, n: int):
    """(hflip, vflip, rotk) of one step's ``n`` images, as numpy arrays."""
    state = np.random.SeedSequence([seed + 1, epoch, step]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state) >> 1)
    hflip = torch.rand(n, generator=gen) < 0.5
    vflip = torch.rand(n, generator=gen) < 0.5
    rotate = torch.rand(n, generator=gen) < 0.5
    k = torch.randint(0, 4, (n,), generator=gen)
    return hflip.numpy(), vflip.numpy(), torch.where(rotate, k, torch.zeros_like(k)).numpy()


def augment(img: np.ndarray, hflip: bool, vflip: bool, rotk: int) -> np.ndarray:
    """Flip left-right, then top-bottom, then rotate by ``rotk`` quarter
    turns (square images; a non-square one turns only by two)."""
    if hflip:
        img = img[:, ::-1]
    if vflip:
        img = img[::-1]
    if img.shape[0] != img.shape[1]:
        rotk = 2 if rotk == 2 else 0
    return np.ascontiguousarray(np.rot90(img, rotk, axes=(0, 1)))


def step_inputs(raw_u8, ref_u8, seed: int, epoch: int, step: int, batch: int, device):
    """The five NCHW [0, 1] float32 planes (x, wb, he, gc, ref) of one step:
    the batch's rows of the epoch's order, through the cache's round trip,
    augmented, with the classical inputs of each augmented raw image."""
    rows = epoch_order(len(raw_u8), seed, epoch)[step * batch:(step + 1) * batch]
    raw = codec.roundtrip(raw_u8[rows])
    ref = codec.roundtrip(ref_u8[rows])
    draws = step_draws(seed, epoch, step, len(rows))
    planes = [[] for _ in range(5)]
    for i in range(len(rows)):
        r = torch.from_numpy(augment(raw[i], *(d[i] for d in draws))).to(device)
        t = torch.from_numpy(augment(ref[i], *(d[i] for d in draws))).to(device)
        wb, gc, he = preprocess.transforms(r)
        for plane, v in zip(planes, (r.to(torch.float32), wb, he, gc, t.to(torch.float32))):
            plane.append(v)
    return [torch.stack(p).permute(0, 3, 1, 2) / 255.0 for p in planes]


def loss_fn(params, vgg, spec, planes, conv=nets.conv2d, perceptual_weight=PERCEPTUAL_WEIGHT):
    """(loss, mse, perceptual) of one batch."""
    x, wb, he, gc, ref = planes
    out = nets.waternet(params, spec, x, wb, he, gc, conv=conv)
    mse = torch.mean(torch.square(255.0 * (out - ref)))
    if not perceptual_weight:
        return mse, mse, torch.zeros_like(mse)
    with torch.no_grad():
        f_ref = nets.vgg19_features(vgg, ref, conv=conv)
    perc = torch.mean(torch.square(255.0 * (nets.vgg19_features(vgg, out, conv=conv) - f_ref)))
    return perceptual_weight * perc + mse, mse, perc


def follow(params0: dict, vgg: dict, spec: dict, raw_u8, ref_u8, seed: int, batch: int, steps: int,
           device, conv=nets.conv2d, perceptual_weight=PERCEPTUAL_WEIGHT, epoch: int = 0) -> dict:
    """Train a copy of ``params0`` for ``steps`` steps of ``epoch`` from its
    first batch; returns each step's loss and its two terms, each leaf's
    first gradient (a CPU tensor) and its norm, and each leaf's change
    after the last step, as floats."""
    names = sorted(params0)
    params = {n: params0[n].detach().to(device, torch.float32).clone().requires_grad_(True) for n in names}
    frozen = {k: v.to(device, torch.float32) for k, v in vgg.items()}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, mses, percs, grad_norms, first = [], [], [], {}, {}
    for t in range(1, steps + 1):
        planes = step_inputs(raw_u8, ref_u8, seed, epoch, t - 1, batch, device)
        loss, mse, perc = loss_fn(params, frozen, spec, planes, conv, perceptual_weight)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        mses.append(float(mse.detach()))
        percs.append(float(perc.detach()))
        with torch.no_grad():
            for n, g in zip(names, grads):
                if t == 1:
                    grad_norms[n] = float(torch.linalg.vector_norm(g.double()))
                    first[n] = g.detach().cpu()
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                m_hat = m[n] / (1 - BETAS[0] ** t)
                v_hat = v[n] / (1 - BETAS[1] ** t)
                params[n].sub_(LR * m_hat / (torch.sqrt(v_hat) + EPS))
    change = {n: float(torch.linalg.vector_norm((params[n].detach() - params0[n].to(device)).double()))
              for n in names}
    return {"loss": losses, "mse": mses, "perceptual": percs, "grads": first, "grad_norms": grad_norms,
            "change_norms": change}
