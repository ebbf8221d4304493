"""R004 negative: build once, reuse."""

import torch
from waternet_tpu_torch.ops import _build


def build(model):
    lib = _build.load()
    fast = torch.compile(model)
    return lib, fast


def serve(fast, batches):
    return [fast(b) for b in batches]


def configure():
    torch.backends.cudnn.benchmark = False
    for shape in [(1, 3, 8, 8)]:
        def make():
            return torch.jit.script(torch.nn.ReLU())  # defined, not run, per pass
        make
    return shape
