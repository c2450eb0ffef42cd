"""Control-flow layers. Parity: reference layers/control_flow.py and the JAX
package's fluid/layers/control_flow.py, reduced to `min_`, which
noam_decay needs. The sub-block constructs (While, Switch, IfElse,
StaticRNN, DynamicRNN), the tensor-array ops and the compare ops wait for
the sequences and control-flow slice of the port."""
__all__ = []


def min_(x, y):
    from .ops import elementwise_min
    return elementwise_min(x, y)
