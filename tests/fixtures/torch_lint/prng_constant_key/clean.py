"""CLEAN: the seed comes from the caller (a CLI flag or a config)."""
import torch

from chainermn_tpu_torch import prng


def init(shape, seed):
    torch.manual_seed(seed)
    g = torch.Generator().manual_seed(seed + 1)
    key = prng.PRNGKey(seed)
    return torch.randn(shape, generator=g), prng.uniform(key, shape)
