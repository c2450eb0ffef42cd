"""fluid.layers: the layer builders this slice of the port carries — those
models/transformer.py calls (parity: the JAX package's fluid/layers)."""
from . import nn
from .nn import *  # noqa: F401,F403
from . import ops
from .ops import *  # noqa: F401,F403
from . import tensor
from .tensor import *  # noqa: F401,F403
from . import io
from .io import *  # noqa: F401,F403

__all__ = nn.__all__ + ops.__all__ + tensor.__all__ + io.__all__
