"""IMDB sentiment. Parity: reference python/paddle/dataset/imdb.py and the
JAX package's dataset/imdb.py: the same synthetic corpus, sample for
sample (a word-id sequence of 8-99 ids drawn 70% from its label's half of
the vocabulary, and a 0/1 label), since neither package downloads."""
import numpy as np

from . import common

__all__ = ['train', 'test', 'word_dict', 'build_dict', 'convert']

_VOCAB = 5147


def word_dict():
    return {('w%d' % i): i for i in range(_VOCAB)}


def _synthetic(n, tag):
    rng = common.synthetic_rng('imdb_' + tag)
    pos_words = np.arange(0, _VOCAB // 2)
    neg_words = np.arange(_VOCAB // 2, _VOCAB)
    for _ in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(8, 100))
        pool = pos_words if label else neg_words
        mix = rng.randint(0, _VOCAB, size=length)
        bias = pool[rng.randint(0, len(pool), size=length)]
        take = rng.rand(length) < 0.7
        seq = np.where(take, bias, mix).astype('int64')
        yield list(seq), label


def train(word_idx=None):
    def reader():
        for s in _synthetic(2048, 'train'):
            yield s
    return reader


def test(word_idx=None):
    def reader():
        for s in _synthetic(256, 'test'):
            yield s
    return reader


def build_dict(pattern=None, cutoff=None):
    """reference imdb.py:build_dict (word -> id); the synthetic vocabulary."""
    return word_dict()


def convert(path):
    """Serialize train/test to recordio (reference imdb.py:convert)."""
    w = word_dict()
    common.convert(path, train(w), 1000, "imdb_train")
    common.convert(path, test(w), 1000, "imdb_test")
