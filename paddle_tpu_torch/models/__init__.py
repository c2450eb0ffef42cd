"""Model builders of the port (parity: the JAX package's models/, with its
registry: model_list and get_model_module)."""
from . import deepfm  # noqa: F401
from . import fit_a_line  # noqa: F401
from . import label_semantic_roles  # noqa: F401
from . import machine_translation  # noqa: F401
from . import mnist  # noqa: F401
from . import recommender_system  # noqa: F401
from . import resnet  # noqa: F401
from . import se_resnext  # noqa: F401
from . import stacked_dynamic_lstm  # noqa: F401
from . import transformer  # noqa: F401
from . import understand_sentiment  # noqa: F401
from . import vgg  # noqa: F401
from . import word2vec  # noqa: F401

__all__ = ['model_list', 'get_model_module', 'deepfm', 'fit_a_line', 'label_semantic_roles',
           'machine_translation', 'mnist', 'recommender_system', 'resnet',
           'se_resnext', 'stacked_dynamic_lstm', 'transformer',
           'understand_sentiment', 'vgg', 'word2vec']

model_list = ['fit_a_line', 'mnist', 'vgg', 'resnet',
              'stacked_dynamic_lstm', 'machine_translation', 'transformer',
              'deepfm', 'word2vec', 'se_resnext', 'understand_sentiment',
              'label_semantic_roles', 'recommender_system']


def get_model_module(name):
    """The module paddle_tpu_torch.models.<name> of a name in model_list."""
    import importlib
    if name not in model_list:
        raise ValueError("unknown model %r (choose from %s)" %
                         (name, model_list))
    return importlib.import_module('paddle_tpu_torch.models.' + name)
