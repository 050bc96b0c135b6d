"""CLEAN: read the result off the card first, then take the lock for the
bookkeeping only."""
import threading

import torch


class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self.done = 0

    def step(self, x):
        y = x * 2
        torch.cuda.synchronize()
        total = int(y.sum().item())
        with self._lock:
            self.done = total
        return y
