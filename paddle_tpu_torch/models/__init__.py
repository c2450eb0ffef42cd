"""Model builders of the port (parity: paddle_tpu.models)."""
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

__all__ = ['deepfm', 'fit_a_line', 'label_semantic_roles',
           'machine_translation', 'mnist', 'recommender_system', 'resnet',
           'se_resnext', 'stacked_dynamic_lstm', 'transformer',
           'understand_sentiment', 'vgg', 'word2vec']
