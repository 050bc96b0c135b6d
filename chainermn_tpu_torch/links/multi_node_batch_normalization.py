"""Cross-rank synchronized BatchNorm.

Counterpart of ``chainermn_tpu/links/multi_node_batch_normalization.py``
(reference: ``chainermn/links/multi_node_batch_normalization.py``): the
batch moments span every rank's shard.  Each rank's mean and mean of
squares, in fp32, go through ONE differentiable all-reduce (the
reference's sum / squared-sum pair), so the gradient flows across ranks
through its backward (an all-reduce of the cotangents); the variance is
``E[x²] − E[x]²``, as flax computes it.  The feature axis is the last.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..functions.collective import _pmean
from ..topology import DEFAULT_AXIS_NAME


class MultiNodeBatchNormalization(nn.Module):
    """BatchNorm whose batch moments are means over every rank's rows.

    It equals one-process BatchNorm over the gathered global batch when the
    ranks hold equal shards.  ``axis_name`` names the world (or is a
    :class:`~chainermn_tpu_torch.topology.Mesh`); with ``None``, or with
    no process group, it is local BatchNorm.  The running statistics
    (buffers ``mean`` and ``var``) move as ``momentum·ra + (1 −
    momentum)·batch`` whenever the batch moments are used; ``scale`` and
    ``bias`` are fp32 parameters, and the output is in ``dtype`` (default:
    the input's)."""

    def __init__(self, num_features: int,
                 axis_name=DEFAULT_AXIS_NAME, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 use_running_average: bool = False):
        super().__init__()
        self.axis_name = axis_name
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.use_running_average = use_running_average
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x, use_running_average: Optional[bool] = None):
        use_ra = (use_running_average if use_running_average is not None
                  else self.use_running_average)
        xf = x.float()
        if use_ra:
            mean, var = self.mean, self.var
        else:
            dims = tuple(range(x.dim() - 1))
            moments = torch.stack([xf.mean(dims), xf.square().mean(dims)])
            if self.axis_name is not None and dist.is_initialized():
                moments = _pmean(moments, self.axis_name)
            mean, mean_sq = moments.unbind(0)
            var = mean_sq - mean.square()
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale + self.bias
        return y.to(self.dtype or x.dtype)
