"""R003 suppressed: the window fetch of a sentinel, argued for in place."""

from torch import nn


class Engine:
    def __init__(self):
        self.net = nn.Linear(4, 4)

    def epoch(self, batches, window):
        for i, x in enumerate(batches):
            out = self.net(x)
            if i % window == 0:
                out.sum().item()  # jaxlint: disable=R003 one read per window, by design
