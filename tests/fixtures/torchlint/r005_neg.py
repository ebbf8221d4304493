"""R005 negative: detached, no-grad, or step-local values."""

import torch
from torch import nn


class Trainer:
    def __init__(self):
        self.net = nn.Linear(4, 1)
        self.losses = []

    def step(self, x, y):
        out = self.net(x)
        loss = nn.functional.mse_loss(out, y)
        loss.backward()
        self.last_out = out.detach()
        self.losses.append(loss.item())
        metrics = {"loss": loss}  # a step-local container, returned
        return metrics

    @torch.no_grad()
    def evaluate(self, x):
        self.last_eval = self.net(x)
        return self.last_eval

    def epoch(self, batches):
        total = torch.zeros(())
        for x, y in batches:
            with torch.no_grad():
                total += self.net(x).mean()
        return float(total)
