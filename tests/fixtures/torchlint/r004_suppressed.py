"""R004 suppressed: a rebuild per config, argued for in place."""

import torch


def sweep(models):
    out = []
    for m in models:
        # jaxlint: disable-next=R004 a one-off sweep: each config is compiled once
        out.append(torch.compile(m))
    return out
