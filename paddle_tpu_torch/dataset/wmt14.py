"""WMT14 en-fr. Parity: reference python/paddle/dataset/wmt14.py and the
JAX package's dataset/wmt14.py: the same synthetic corpus, sample for
sample (source ids, `<s>` + target ids, target ids + `</s>`; the target a
shifted copy of the source), since neither package downloads."""
from . import common

__all__ = ['train', 'test', 'get_dict', 'convert', 'N']

N = 30000  # vocab size in reference's pruned dict


def _synthetic(n, tag, dict_size):
    rng = common.synthetic_rng('wmt14_' + tag)
    for _ in range(n):
        slen = int(rng.randint(4, 30))
        src = [int(w) for w in rng.randint(3, dict_size, size=slen)]
        trg = [(w + 7) % dict_size for w in src[:max(2, slen - 2)]]
        trg = [max(3, w) for w in trg]
        yield src, [0] + trg, trg + [1]


def train(dict_size=N):
    def reader():
        for s in _synthetic(2048, 'train', dict_size):
            yield s
    return reader


def test(dict_size=N):
    def reader():
        for s in _synthetic(256, 'test', dict_size):
            yield s
    return reader


def get_dict(dict_size, reverse=True):
    """reference wmt14.py:get_dict -> (src_dict, trg_dict); id -> word when
    reverse (the reference default)."""
    d = {('w%d' % i): i for i in range(dict_size)}
    if reverse:
        d = {v: k for k, v in d.items()}
    return d, dict(d)


def convert(path):
    """Serialize train/test to recordio (reference wmt14.py:convert)."""
    dict_size = 30000
    common.convert(path, train(dict_size), 1000, "wmt14_train")
    common.convert(path, test(dict_size), 1000, "wmt14_test")
