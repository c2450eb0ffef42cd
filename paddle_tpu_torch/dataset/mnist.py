"""MNIST. Parity: reference python/paddle/dataset/mnist.py and the JAX
package's dataset/mnist.py: (784 floats in [-1, 1], int label). The
synthetic corpus only (no download): 10 fixed prototype digits plus
noise, so simple models learn separable structure; 8,192 training and
1,024 test samples."""
import numpy as np

from . import common

__all__ = ['train', 'test', 'convert']


def _synthetic(n, tag):
    rng = common.synthetic_rng('mnist_' + tag)
    protos = common.synthetic_rng('mnist_protos').uniform(
        -1, 1, size=(10, 784)).astype('float32')
    labels = rng.randint(0, 10, size=n).astype('int64')
    images = protos[labels] + 0.35 * rng.randn(n, 784).astype('float32')
    return np.clip(images, -1, 1).astype('float32'), labels


def _reader_creator(tag, n):
    def reader():
        images, labels = _synthetic(n, tag)
        for i in range(len(labels)):
            yield images[i], int(labels[i])
    return reader


def train():
    return _reader_creator('train', 8192)


def test():
    return _reader_creator('test', 1024)


def convert(path):
    """Serialize train/test to recordio (reference mnist.py:convert, its
    'minist' prefix kept)."""
    common.convert(path, train(), 1000, "minist_train")
    common.convert(path, test(), 1000, "minist_test")
