"""Movie-review sentiment. Parity: reference
python/paddle/dataset/sentiment.py and the JAX package's
dataset/sentiment.py: imdb's synthetic corpus and word dict."""
from . import common, imdb

__all__ = ['train', 'test', 'get_word_dict', 'convert']


def get_word_dict():
    return imdb.word_dict()


def train():
    return imdb.train()


def test():
    return imdb.test()


def convert(path):
    """Serialize train/test to recordio (reference sentiment.py:convert)."""
    common.convert(path, train(), 1000, "sentiment_train")
    common.convert(path, test(), 1000, "sentiment_test")
