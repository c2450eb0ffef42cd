"""CoNLL-2005 semantic role labelling. Parity: reference
python/paddle/dataset/conll05.py and the JAX package's dataset/
conll05.py: the same synthetic corpus, sample for sample, and the same
pretrained-embedding file, byte for byte, since neither package
downloads. `convert` (recordio) waits for the trainer-and-data slice of
the port."""
import os

import numpy as np

from . import common

__all__ = ['get_dict', 'get_embedding', 'train', 'test', 'convert']

_WORD, _VERB, _LABEL = 44068, 3162, 59


def get_dict():
    word_dict = {('w%d' % i): i for i in range(_WORD)}
    verb_dict = {('v%d' % i): i for i in range(_VERB)}
    label_dict = {('l%d' % i): i for i in range(_LABEL)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """The path of the pretrained word-embedding FILE (the reference
    downloads one; book code reads a 16-byte header, then raw float32
    [vocab, 32]). The synthetic table is written once into the dataset
    cache in that layout: through a temporary file unique to the process,
    then renamed over the path, so processes that race write whole files
    of the same bytes."""
    path = os.path.join(common.data_home(), 'conll05_emb.bin')
    if not os.path.exists(path):
        rng = common.synthetic_rng('conll05_emb')
        emb = rng.uniform(-1, 1, size=(_WORD, 32)).astype('float32')
        tmp = '%s.%d.tmp' % (path, os.getpid())
        with open(tmp, 'wb') as f:
            f.write(b'\0' * 16)  # header, skipped by readers
            emb.tofile(f)
        os.replace(tmp, path)
    return path


def _synthetic(n, tag):
    """Nine slots, as the real corpus's samples (word, ctx_n2, ctx_n1,
    ctx_0, ctx_p1, ctx_p2, verb, mark, target), 5-20 tokens each. The
    target is a noisy function of (word, mark): 6 effective labels of the
    59, 3% noise."""
    rng = common.synthetic_rng('conll05_' + tag)
    for _ in range(n):
        slen = int(rng.randint(5, 21))
        word = rng.randint(0, _WORD, size=slen)
        ctxs = [np.roll(word, k) for k in (2, 1, 0, -1, -2)]
        verb = [int(rng.randint(0, _VERB))] * slen
        mark = rng.randint(0, 2, size=slen)
        noise = rng.randint(0, _LABEL, size=slen)
        label = np.where(rng.rand(slen) < 0.97,
                         (word % 3) + mark * 3,
                         noise)
        yield tuple([[int(v) for v in word]]
                    + [[int(v) for v in c] for c in ctxs]
                    + [verb, [int(v) for v in mark],
                       [int(v) for v in label]])


def train():
    def reader():
        for s in _synthetic(1024, 'train'):
            yield s
    return reader


def test():
    def reader():
        # the reference book trains its CRF on this split
        for s in _synthetic(768, 'test'):
            yield s
    return reader


def convert(path):
    """Serialize the test split to recordio (reference conll05.py:convert,
    its 'conl105_test' prefix kept)."""
    common.convert(path, test(), 1000, "conl105_test")
