"""BAD: one threefry key consumed twice — the two draws are the same bits."""
from chainermn_tpu_torch import prng


def sample(key, shape):
    noise = prng.uniform(key, shape)
    gumbel = prng.gumbel(key, shape)          # same key, same bits
    return noise, gumbel
