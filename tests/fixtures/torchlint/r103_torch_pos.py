"""R103 positive, the torch entries: device syncs under a lock."""

import threading

import torch

_LOCK = threading.Lock()


def read_under_lock(out):
    with _LOCK:
        torch.cuda.synchronize()  # BAD: waits for the whole device under the lock


def event_under_lock(event):
    with _LOCK:
        event.synchronize()  # BAD


def item_under_lock(x):
    with _LOCK:
        return torch.relu(x).sum().item()  # BAD: a device readback under the lock
