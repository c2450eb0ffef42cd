"""MQ2007 learning to rank. Parity: reference python/paddle/dataset/mq2007.py
and the JAX package's dataset/mq2007.py: the same synthetic corpus, sample
for sample (46 features a document; a fixed latent linear scorer orders
the pairs and grades the points), since neither package downloads."""
import numpy as np

from . import common

__all__ = ['train', 'test']

_FEATS = 46


def _reader(tag, n, format):
    def reader():
        rng = common.synthetic_rng('mq2007_' + tag)
        w = common.synthetic_rng('mq2007_w').randn(_FEATS)
        for _ in range(n):
            if format == 'pairwise':
                a = rng.rand(_FEATS).astype('float32')
                b = rng.rand(_FEATS).astype('float32')
                # the better-scored document first
                if float(a @ w) >= float(b @ w):
                    yield a, b
                else:
                    yield b, a
            else:
                x = rng.rand(_FEATS).astype('float32')
                score = float(x @ w)
                label = float(np.clip(round(score + 1.5), 0, 2))
                yield label, x
    return reader


def train(format='pairwise'):
    return _reader('train', 2048, format)


def test(format='pairwise'):
    return _reader('test', 256, format)
