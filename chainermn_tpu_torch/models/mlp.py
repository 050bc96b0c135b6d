"""MNIST-scale MLP and the classification loss, in PyTorch.

Counterpart of ``chainermn_tpu/models/mlp.py``: the 3-layer MLP
(``n_units`` → ``n_units`` → ``n_out``, ReLU) and ``cross_entropy_loss`` /
``accuracy`` over integer labels.  flax infers the input width at the
first call; here it is ``n_in``.  Layers are named as flax names them
(``Dense_0`` …).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class MLP(nn.Module):
    def __init__(self, n_in: int, n_units: int = 1000, n_out: int = 10):
        super().__init__()
        self.Dense_0 = nn.Linear(n_in, n_units)
        self.Dense_1 = nn.Linear(n_units, n_units)
        self.Dense_2 = nn.Linear(n_units, n_out)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


def cross_entropy_loss(logits, labels):
    """Mean negative log-likelihood of ``labels`` under ``softmax(logits)``."""
    logp = torch.gather(F.log_softmax(logits, -1), -1, labels.long()[:, None])
    return -logp.mean()


def accuracy(logits, labels):
    return (logits.argmax(-1) == labels.long()).float().mean()
