"""R005 suppressed: a graph kept on purpose, argued for in place."""

from torch import nn


class Probe:
    def __init__(self):
        self.net = nn.Linear(4, 1)

    def capture(self, x):
        out = self.net(x)
        self.kept = out  # jaxlint: disable=R005 the probe differentiates it later, once
        return out
