"""R001 negative: the sanctioned hand-offs (DeviceFeeder's shape)."""

import torch


def send(host_tensors, device, stream):
    with torch.cuda.stream(stream):
        out = [t.pin_memory().to(device, non_blocking=True) for t in host_tensors]
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def receive(sent, device):
    tensors, event = sent
    if event is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(event)
        for t in tensors:
            t.record_stream(stream)
    return tensors


def producer_waits_and_records(x):
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y = torch.relu(x)
    torch.cuda.current_stream().wait_stream(side)
    y.record_stream(torch.cuda.current_stream())
    return y.sum()


def start_readback(t):
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def finish_readback(handle):
    host, event = handle
    event.synchronize()
    host.mul_(2)
    return host
