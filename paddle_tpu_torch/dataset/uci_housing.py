"""UCI housing. Parity: reference python/paddle/dataset/uci_housing.py and
the JAX package's dataset/uci_housing.py: 13 features -> price. The
synthetic corpus only (no download): a linear ground truth plus noise at
the real set's 506 rows, normalized as the reference normalizes, the first
80% for training."""
import numpy as np

from . import common

__all__ = ['train', 'test', 'feature_range', 'convert']

_DATA = {}


def _load():
    if _DATA:
        return
    rng = common.synthetic_rng('uci_housing')
    n = 506
    x = rng.uniform(-1, 1, size=(n, 13))
    w = rng.uniform(-2, 2, size=(13,))
    y = x @ w + 0.1 * rng.randn(n) + 22.0
    data = np.concatenate([x, y[:, None]], axis=1)
    maximums, minimums = data.max(axis=0), data.min(axis=0)
    avgs = data.sum(axis=0) / data.shape[0]
    for i in range(13):
        data[:, i] = (data[:, i] - avgs[i]) / (maximums[i] - minimums[i])
    offset = int(data.shape[0] * 0.8)
    _DATA['train'] = data[:offset].astype('float32')
    _DATA['test'] = data[offset:].astype('float32')


def _reader(split):
    _load()
    rows = _DATA[split]

    def reader():
        for d in rows:
            yield d[:-1], d[-1:]
    return reader


def train():
    return _reader('train')


def test():
    return _reader('test')


def feature_range(maximums, minimums):
    """The reference draws the features' ranges as a bar chart with
    matplotlib; as in the JAX package, nothing is drawn here."""
    return None


def convert(path):
    """Serialize train/test to recordio (reference uci_housing.py:convert,
    its 'uci_houseing_test' prefix kept)."""
    common.convert(path, train(), 1000, "uci_housing_train")
    common.convert(path, test(), 1000, "uci_houseing_test")
