"""CLEAN: fold a distinct datum into the key before each draw."""
from chainermn_tpu_torch import prng


def sample(key, shape):
    k1 = prng.fold_in(key, 1)
    noise = prng.uniform(k1, shape)
    k2 = prng.fold_in(key, 2)
    gumbel = prng.gumbel(k2, shape)
    return noise, gumbel
