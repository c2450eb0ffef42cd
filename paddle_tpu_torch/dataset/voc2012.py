"""PASCAL VOC2012 segmentation. Parity: reference
python/paddle/dataset/voc2012.py and the JAX package's dataset/voc2012.py:
the same synthetic corpus, sample for sample (3x128x128 float32 images,
128x128 int32 masks of 21 classes), since neither package downloads."""
from . import common

__all__ = ['train', 'test', 'val']


def _reader(tag, n):
    def reader():
        rng = common.synthetic_rng('voc2012_' + tag)
        for _ in range(n):
            img = rng.rand(3, 128, 128).astype('float32')
            label = rng.randint(0, 21, size=(128, 128)).astype('int32')
            yield img, label
    return reader


def train():
    return _reader('train', 128)


def test():
    return _reader('test', 32)


def val():
    return _reader('val', 32)
