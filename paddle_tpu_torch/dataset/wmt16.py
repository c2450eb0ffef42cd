"""WMT16 en-de (used by Transformer). Parity: reference
python/paddle/dataset/wmt16.py and the JAX package's dataset/wmt16.py: the
same synthetic corpus, sample for sample (a seeded copy task with a fixed
token map), since neither package downloads."""
from . import common

__all__ = ['train', 'test', 'validation', 'get_dict', 'fetch',
           'convert']


def get_dict(lang, dict_size, reverse=False):
    d = {('w%d' % i): i for i in range(dict_size)}
    if reverse:
        return {v: k for k, v in d.items()}
    return d


def _synthetic(n, tag, src_dict_size, trg_dict_size):
    rng = common.synthetic_rng('wmt16_' + tag)
    for _ in range(n):
        slen = int(rng.randint(4, 50))
        src = [int(w) for w in rng.randint(3, src_dict_size, size=slen)]
        trg = [max(3, (w * 3 + 11) % trg_dict_size) for w in src]
        yield src, [0] + trg, trg + [1]


def train(src_dict_size=10000, trg_dict_size=10000, src_lang='en'):
    def reader():
        for s in _synthetic(2048, 'train', src_dict_size, trg_dict_size):
            yield s
    return reader


def test(src_dict_size=10000, trg_dict_size=10000, src_lang='en'):
    def reader():
        for s in _synthetic(256, 'test', src_dict_size, trg_dict_size):
            yield s
    return reader


def validation(src_dict_size=10000, trg_dict_size=10000, src_lang='en'):
    """reference wmt16.py:validation (held-out split)."""
    def reader():
        for s in _synthetic(256, 'valid', src_dict_size, trg_dict_size):
            yield s
    return reader


def fetch():
    """Nothing to download: the corpus is synthetic, made as it is read
    (reference wmt16.py:fetch downloads it beforehand). Returns None, as
    the JAX package's does."""
    return None


def convert(path, src_dict_size=10000, trg_dict_size=10000, src_lang='en'):
    """Serialize the three splits to recordio (reference
    wmt16.py:convert)."""
    common.convert(path, train(src_dict_size, trg_dict_size, src_lang),
                   1000, "wmt16_train")
    common.convert(path, test(src_dict_size, trg_dict_size, src_lang),
                   1000, "wmt16_test")
    common.convert(path, validation(src_dict_size, trg_dict_size, src_lang),
                   1000, "wmt16_validation")
