"""R002 negative: explicit generators and the fork_rng idiom."""

import numpy as np
import torch
from torch import nn


class Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(4, 4)
        nn.init.xavier_uniform_(self.proj.weight)  # a module's constructor


def augment(x, generator):
    flip = torch.rand(x.shape[0], generator=generator) < 0.5
    return torch.where(flip[:, None], x.flip(-1), x)


def shuffle(items, seed):
    rng = np.random.default_rng(seed)
    return [items[i] for i in rng.permutation(len(items))]


def seeded_init(seed):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        head = Head()
        nn.init.zeros_(head.proj.bias)
        torch.randn(3)
    return head


def step_generator(seed):
    return torch.Generator().manual_seed(seed)
