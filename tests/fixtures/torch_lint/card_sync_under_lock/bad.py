"""BAD: waiting for the card while holding a lock — every thread that
needs the lock stalls for the card's whole queue."""
import threading

import torch


class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self.done = 0

    def step(self, x):
        with self._lock:
            y = x * 2
            torch.cuda.synchronize()
            self.done = int(y.sum().item())
        return y
