"""R005 positive: tensors with autograd history stored past the step."""

import torch
from torch import nn

HISTORY = []


class Trainer:
    def __init__(self):
        self.net = nn.Linear(4, 1)
        self.losses = []

    def step(self, x, y):
        out = self.net(x)
        loss = nn.functional.mse_loss(out, y)
        loss.backward()
        self.last_out = out  # BAD: keeps the graph alive
        self.losses.append(loss)  # BAD: a container on self
        HISTORY.append(loss * 2)  # BAD: a module-level container
        return loss.detach()

    def epoch(self, batches):
        total = 0
        for x, y in batches:
            out = self.net(x)
            total += torch.mean(out)  # BAD: accumulated across the loop
        return total
