"""PTB language-model n-grams. Parity: reference
python/paddle/dataset/imikolov.py and the JAX package's dataset/
imikolov.py: the same synthetic corpus, sample for sample (Zipfian
Markov n-grams from common.synthetic_rng), since neither package
downloads. `convert` (recordio) waits for the trainer-and-data slice of
the port."""
import numpy as np

from . import common

__all__ = ['train', 'test', 'build_dict', 'convert']

_VOCAB = 2073


def build_dict(min_word_freq=50):
    return {('w%d' % i): i for i in range(_VOCAB)}


def _zipf_probs():
    # Zipfian, as real PTB is: frequent words dominate the loss, so the
    # book's bottlenecked n-gram model can learn the head of the
    # distribution
    ranks = np.arange(1, _VOCAB + 1, dtype=np.float64)
    p = 1.0 / ranks ** 1.1
    return p / p.sum()


def _synthetic(n, tag, ngram):
    rng = common.synthetic_rng('imikolov_' + tag)
    probs = _zipf_probs()
    # Markov chains, so the n-gram task is learnable
    trans = common.synthetic_rng('imikolov_trans').choice(
        _VOCAB, size=(_VOCAB,), p=probs)
    for _ in range(n):
        w = [int(rng.choice(_VOCAB, p=probs))]
        for _ in range(ngram - 1):
            nxt = int(trans[w[-1]]) if rng.rand() < 0.8 \
                else int(rng.choice(_VOCAB, p=probs))
            w.append(nxt)
        yield tuple(w)


def train(word_idx=None, n=5):
    def reader():
        for s in _synthetic(4096, 'train', n):
            yield s
    return reader


def test(word_idx=None, n=5):
    def reader():
        for s in _synthetic(512, 'test', n):
            yield s
    return reader


def convert(path):
    """Serialize train/test 5-grams to recordio (reference
    imikolov.py:convert)."""
    N = 5
    word_dict = build_dict()
    common.convert(path, train(word_dict, N), 1000, "imikolov_train")
    common.convert(path, test(word_dict, N), 1000, "imikolov_test")
