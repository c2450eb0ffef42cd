"""fluid.layers: the layer builders the port carries (parity: the JAX
package's fluid/layers)."""
from . import nn
from .nn import *  # noqa: F401,F403
from . import ops
from .ops import *  # noqa: F401,F403
from . import tensor
from .tensor import *  # noqa: F401,F403
from . import control_flow
from .control_flow import *  # noqa: F401,F403
from . import io
from .io import *  # noqa: F401,F403
from . import device  # noqa: F401
from . import metric_op
from .metric_op import *  # noqa: F401,F403
from . import math_op_patch  # noqa: F401 (patches Variable operators)
from . import learning_rate_scheduler
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import detection
from .detection import *  # noqa: F401,F403
from . import layer_function_generator
from .layer_function_generator import *  # noqa: F401,F403

__all__ = layer_function_generator.__all__ + nn.__all__ + ops.__all__ + tensor.__all__ + \
    control_flow.__all__ + io.__all__ + metric_op.__all__ + \
    learning_rate_scheduler.__all__ + detection.__all__
