"""R001 suppressed: a deliberate cross-stream read, argued for in place."""

import torch


def one_shot(x):
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y = torch.relu(x)
    torch.cuda.synchronize()
    return y.sum()  # jaxlint: disable=R001 the whole device is synchronized and y dies here
