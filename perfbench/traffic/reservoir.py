"""A uniform sample of a stream of unknown length, drawn from a seed."""

from __future__ import annotations

import random


class Reservoir:
    """Keeps ``k`` of the items offered, each offered item equally likely."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = int(k), rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item
