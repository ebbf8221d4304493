"""R003 positive: host syncs in loops that launch device work."""

import torch
from torch import nn


class Engine:
    def __init__(self):
        self.net = nn.Conv2d(3, 3, 3)

    def train_step(self, x):
        out = self.net(x)
        if out.mean() > 0:  # BAD: a device tensor as an `if` test, in a step method
            out = out * 2
        return {"loss": out.mean()}

    def epoch(self, batches):
        losses = []
        for x in batches:
            m = self.train_step(x)
            losses.append(m["loss"].item())  # BAD: .item() per step
        return losses

    def epoch_float(self, batches):
        total = 0.0
        for x in batches:
            m = self.train_step(x)
            total += float(m["loss"])  # BAD: float() of a device tensor
        return total

    def epoch_nested(self, batches):
        pending = []

        def flush():
            vals = torch.stack(pending).cpu()  # BAD: reached from the loop through flush()
            pending.clear()
            return vals

        for x in batches:
            pending.append(self.train_step(x)["loss"])
            if len(pending) >= 4:
                flush()
        return pending


def _drive_train_epoch(payloads, dispatch):
    for x in payloads:
        out = dispatch(x)
        keep = out[out > 0]  # BAD: boolean-mask indexing
        torch.cuda.synchronize()  # BAD: explicit wait
        torch.tensor([1.0, 2.0], device="cuda")  # BAD: a copy of host data from pageable memory
        torch.from_numpy(x).to("cuda")  # BAD: likewise
    return keep
