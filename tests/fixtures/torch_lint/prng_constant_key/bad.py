"""BAD: process-constant randomness in torch: every run and every rank
draws the same values."""
import torch

from chainermn_tpu_torch import prng


def init(shape):
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(42)
    key = prng.PRNGKey(7)
    return torch.randn(shape, generator=g), prng.uniform(key, shape)
