"""Control-flow layers. Parity: reference layers/control_flow.py and the JAX
package's fluid/layers/control_flow.py, reduced to the compare ops,
`increment` and `min_` / `max_`, which the schedulers build with. The
sub-block constructs (While, Switch, IfElse, StaticRNN, DynamicRNN), the
tensor-array ops and is_empty wait for the control-flow slice of the
port."""
from ..layer_helper import LayerHelper

__all__ = ['increment', 'less_than', 'equal']


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment", **locals())
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='increment', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'step': float(value)}, infer_shape=False)
    return out


def less_than(x, y, force_cpu=None, cond=None):
    helper = LayerHelper("less_than", **locals())
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool')
        cond.stop_gradient = True
    helper.append_op(type='less_than', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [cond]})
    return cond


def equal(x, y, cond=None):
    helper = LayerHelper("equal", **locals())
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool')
        cond.stop_gradient = True
    helper.append_op(type='equal', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [cond]})
    return cond


def min_(x, y):
    from .ops import elementwise_min
    return elementwise_min(x, y)


def max_(x, y):
    from .ops import elementwise_max
    return elementwise_max(x, y)
