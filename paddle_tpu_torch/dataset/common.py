"""Dataset plumbing. Parity: reference python/paddle/dataset/common.py and
the JAX package's dataset/common.py (:10 DATA_HOME, :75-78 the synthetic
generator's seed). Downloads, sharding and recordio conversion wait for
the trainer-and-data slice of the port."""
import hashlib
import os

import numpy as np

__all__ = ['DATA_HOME', 'data_home', 'synthetic_rng']

# the port's own cache, apart from the JAX package's ~/.cache/paddle_tpu
DATA_HOME = os.path.expanduser('~/.cache/paddle_tpu_torch/dataset')


def data_home():
    """DATA_HOME, created on first use."""
    os.makedirs(DATA_HOME, exist_ok=True)
    return DATA_HOME


def synthetic_rng(tag, seed=1234):
    """Deterministic per-dataset RNG for synthetic fallbacks."""
    h = int(hashlib.md5(tag.encode()).hexdigest()[:8], 16)
    return np.random.RandomState((seed + h) % (2 ** 31))
