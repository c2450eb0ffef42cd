"""CIFAR-10/100. Parity: reference python/paddle/dataset/cifar.py and the
JAX package's dataset/cifar.py: (3072 floats in [0, 1], int label), from
class prototypes plus noise (the synthetic corpus; no download)."""
import numpy as np

from . import common

__all__ = ['train10', 'test10', 'train100', 'test100']


def _synthetic(n, num_classes, tag):
    rng = common.synthetic_rng('cifar_' + tag + str(num_classes))
    protos = common.synthetic_rng('cifar_protos' + str(num_classes)).uniform(
        0, 1, size=(num_classes, 3072)).astype('float32')
    labels = rng.randint(0, num_classes, size=n).astype('int64')
    images = protos[labels] + 0.15 * rng.randn(n, 3072).astype('float32')
    return np.clip(images, 0, 1).astype('float32'), labels


def _reader_creator(tag, num_classes, n):
    def reader():
        images, labels = _synthetic(n, num_classes, tag)
        for i in range(len(labels)):
            yield images[i], int(labels[i])
    return reader


def train10():
    return _reader_creator('train', 10, 4096)


def test10():
    return _reader_creator('test', 10, 512)


def train100():
    return _reader_creator('train', 100, 4096)


def test100():
    return _reader_creator('test', 100, 512)
