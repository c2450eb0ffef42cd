"""Datasets of the port (parity: the JAX package's paddle_tpu.dataset):
wmt16 for Transformer, uci_housing for fit_a_line, mnist for LeNet, cifar
and flowers for ResNet, imdb (and sentiment over it) for the sentiment and
stacked-LSTM models, wmt14 for machine_translation, imikolov for word2vec,
movielens for recommender_system, conll05 for label_semantic_roles, and
mq2007 (ranking) and voc2012 (segmentation). Each reader yields the JAX
package's deterministic synthetic corpus from a seeded generator; each
`convert` writes it into recordio shards (common.convert)."""
from . import common  # noqa: F401
from . import wmt16  # noqa: F401
from . import uci_housing  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import image  # noqa: F401
from . import flowers  # noqa: F401
from . import imdb  # noqa: F401
from . import wmt14  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05  # noqa: F401
from . import sentiment  # noqa: F401
from . import voc2012  # noqa: F401
from . import mq2007  # noqa: F401

__all__ = ['common', 'wmt16', 'uci_housing', 'mnist', 'cifar', 'image',
           'flowers', 'imdb', 'wmt14', 'imikolov', 'movielens', 'conll05',
           'sentiment', 'voc2012', 'mq2007']
