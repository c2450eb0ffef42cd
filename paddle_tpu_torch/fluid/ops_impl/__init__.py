"""Lowering rules (Fluid op -> PyTorch) for the ops this slice runs.

Importing this package registers all rules. Grouped like the JAX
package's fluid/ops_impl/, one torch rule per op.
"""
from . import math_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import optim_ops  # noqa: F401
