"""R201 positive, the torch entries: device syncs in a coroutine."""

import torch


async def handler(x):
    torch.cuda.synchronize()  # BAD: stalls the event loop
    return torch.relu(x).cpu()  # BAD: a device readback on the loop thread


async def waiter(event):
    event.synchronize()  # BAD
