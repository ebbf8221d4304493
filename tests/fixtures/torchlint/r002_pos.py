"""R002 positive: draws from the process-global generators."""

import numpy as np
import torch
from torch import nn


def augment(x):
    flip = torch.rand(x.shape[0]) < 0.5  # BAD: global torch generator
    noise = torch.randn_like(x)  # BAD
    return torch.where(flip[:, None], x.flip(-1), x) + noise


def jitter(x):
    return x.uniform_(0, 1)  # BAD: in-place sampler, no generator=


def shuffle(items):
    order = np.random.permutation(len(items))  # BAD: numpy's global RandomState
    return [items[i] for i in order]


def init_head(layer):
    nn.init.kaiming_normal_(layer.weight)  # BAD: outside the seeding idiom


def reseed(seed):
    torch.manual_seed(seed)  # BAD: reseeds the caller's stream too
