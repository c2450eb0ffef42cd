"""Lowering rules (Fluid op -> PyTorch) for the ops this slice runs.

Importing this package registers all rules. Grouped like the JAX
package's fluid/ops_impl/, one torch rule per op.
"""
from . import math_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import optim_ops  # noqa: F401
from . import lod_beam  # noqa: F401
from . import sampled_ops  # noqa: F401
from . import extra_ops  # noqa: F401
from . import crf_ctc_ops  # noqa: F401
from . import block_ops  # noqa: F401
from . import control_ops  # noqa: F401
from . import quant_ops  # noqa: F401
from . import detection_ops  # noqa: F401
from . import moe_ops  # noqa: F401
