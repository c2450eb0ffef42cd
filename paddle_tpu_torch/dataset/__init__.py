"""Datasets of the port (parity: the JAX package's paddle_tpu.dataset),
reduced to what its models read: wmt16 for Transformer, uci_housing for
fit_a_line, mnist for LeNet, cifar and flowers for ResNet, imdb for the
sentiment and stacked-LSTM models, wmt14 for machine_translation, imikolov
for word2vec, movielens for recommender_system and conll05 for
label_semantic_roles. They have no download path: each reader yields the
JAX package's deterministic synthetic corpus from a seeded generator."""
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

__all__ = ['common', 'wmt16', 'uci_housing', 'mnist', 'cifar', 'image',
           'flowers', 'imdb', 'wmt14', 'imikolov', 'movielens', 'conll05']
