"""Oxford-102 flowers. Parity: reference python/paddle/dataset/flowers.py
and the JAX package's dataset/flowers.py: readers yield (3x224x224 float32
CHW image flattened, int label in [0, 102)); train applies the random
crop and flip, test and valid the center crop, through a 4-thread
xmap_readers pipeline by default. The synthetic corpus only (no download):
deterministic uint8 HWC 'photos' of 256x320, larger than the crop, so
simple_transform's resize and crop do real work on the host."""
import functools

from . import common, image
from .. import reader as paddle_reader

__all__ = ['train', 'test', 'valid']

_RAW_H, _RAW_W = 256, 320


def default_mapper(is_train, sample):
    img, label = sample
    img = image.simple_transform(
        img, 256, 224, is_train, mean=[103.94, 116.78, 123.68])
    return img.flatten().astype('float32'), label


train_mapper = functools.partial(default_mapper, True)
test_mapper = functools.partial(default_mapper, False)


def _raw_reader(tag, n):
    def reader():
        rng = common.synthetic_rng('flowers_' + tag)
        for _ in range(n):
            label = int(rng.randint(0, 102))
            img = (rng.rand(_RAW_H, _RAW_W, 3) * 255).astype('uint8')
            yield img, label
    return reader


def _reader_creator(tag, n, mapper, use_xmap, buffered_size):
    raw = _raw_reader(tag, n)
    if use_xmap:
        return paddle_reader.xmap_readers(mapper, raw, 4, buffered_size)
    return paddle_reader.map_readers(mapper, raw)


def train(use_xmap=True, mapper=train_mapper, buffered_size=1024):
    return _reader_creator('train', 512, mapper, use_xmap, buffered_size)


def test(use_xmap=True, mapper=test_mapper, buffered_size=1024):
    return _reader_creator('test', 64, mapper, use_xmap, buffered_size)


def valid(use_xmap=True, mapper=test_mapper, buffered_size=1024):
    return _reader_creator('valid', 64, mapper, use_xmap, buffered_size)
