"""R004 positive: rebuilds in a loop or per request."""

import torch
from waternet_tpu_torch.ops import _build


def serve_each(models, x):
    outs = []
    for m in models:
        fast = torch.compile(m)  # BAD: compiled anew every iteration
        outs.append(fast(x))
    return outs


async def handle(request, model):
    prog = torch.export.export(model, (request,))  # BAD: per request
    return prog


class Net(torch.nn.Module):
    def forward(self, x):
        lib = _build.load()  # BAD: the kernel loader on every forward
        return lib, x


def configure():
    torch.backends.cudnn.benchmark = True  # BAD: re-plans per request shape
