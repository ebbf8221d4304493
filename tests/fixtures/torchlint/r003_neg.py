"""R003 negative: the deferred fetch, numpy look-alikes, conversion code."""

import numpy as np
import torch
from torch import nn


class Engine:
    def __init__(self):
        self.net = nn.Conv2d(3, 3, 3)

    def train_step(self, x):
        out = self.net(x)
        return {"loss": out.mean()}

    def epoch(self, batches):
        per_step = [self.train_step(x) for x in batches]
        for m in per_step:  # a fetch-only loop launches nothing
            float(m["loss"])
        return torch.stack([m["loss"] for m in per_step]).cpu().tolist()


def plan(y1, y2, rows):
    edges = []
    for _ in range(2):
        change = np.flatnonzero((np.diff(y1) != 0) | (np.diff(y2) != 0)) + 1
        edges.append([0, *change.tolist(), rows])  # numpy: no sync
    return edges


def convert(layers):
    out = []
    for layer in layers:
        w = torch.as_tensor(layer["weight"]).detach().cpu().numpy()  # conversion time, no launch
        out.append(w)
    return out


def upload(batches, device):
    for b in batches:
        t = torch.from_numpy(b).pin_memory().to(device, non_blocking=True)
        nn.functional.relu(t)
    return int(len(batches))
