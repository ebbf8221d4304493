"""R001 positive: tensors handed across CUDA streams without ownership."""

import torch


def producer_uses_after_block(x, device):
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        y = torch.relu(x.to(device, non_blocking=True))
    return y.sum() + 1  # BAD: no wait on `side`, no record_stream


def producer_returns_without_event(x):
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y = torch.relu(x)
    return y  # BAD: the consumer has no event to wait on


def consumer_without_record_stream(sent, device):
    tensors, event = sent
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)  # BAD: tensors never marked with record_stream
    return tensors


def host_buffer_written_before_wait(device):
    host = torch.empty(1024, pin_memory=True)
    dev = host.to(device, non_blocking=True)
    host.fill_(0)  # BAD: the copy may still be reading `host`
    return dev


def readback_read_before_wait(t):
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    total = host.sum()  # BAD: the copy may not have landed yet
    return total
