"""Dataset plumbing. Parity: reference python/paddle/dataset/common.py and
the JAX package's dataset/common.py:75-78, reduced to the synthetic
generator's seed; downloads, sharding and recordio conversion wait for the
data slice of the port."""
import hashlib

import numpy as np

__all__ = ['synthetic_rng']


def synthetic_rng(tag, seed=1234):
    """Deterministic per-dataset RNG for synthetic fallbacks."""
    h = int(hashlib.md5(tag.encode()).hexdigest()[:8], 16)
    return np.random.RandomState((seed + h) % (2 ** 31))
