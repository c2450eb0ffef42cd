"""Learning-rate schedules built from graph ops.

Parity: reference layers/learning_rate_scheduler.py and the JAX package's
fluid/layers/learning_rate_scheduler.py. A schedule appends ops, driven by
the persistable @LR_DECAY_COUNTER@ step var, that compute the lr the
optimizer's update ops read; the Executor runs them every step (a
captured step replays them on the device). piecewise_decay is masked sums,
as in the JAX package, not the reference's Switch block.
"""
import math

from ..framework import ROLE_LRSCHED
from ..layer_helper import LayerHelper
from ..initializer import Constant
from . import control_flow
from . import ops
from . import tensor

__all__ = [
    'exponential_decay', 'natural_exp_decay', 'inverse_time_decay',
    'polynomial_decay', 'piecewise_decay', 'noam_decay', 'append_LARS',
]


def _decay_step_counter(begin=0):
    """Persistable global step, incremented once per run (reference
    layers/learning_rate_scheduler.py:_decay_step_counter)."""
    helper = LayerHelper('global_step_counter')
    counter_name = '@LR_DECAY_COUNTER@'
    blk = helper.main_program.global_block()
    if counter_name in blk.vars:
        counter = blk.vars[counter_name]
    else:
        counter = helper.create_global_variable(
            name=counter_name, dtype='float32', shape=[1], persistable=True)
        helper.set_variable_initializer(counter,
                                        Constant(value=float(begin - 1)))
    helper.append_op(type='increment', inputs={'X': [counter]},
                     outputs={'Out': [counter]},
                     attrs={'step': 1.0, 'op_role': ROLE_LRSCHED},
                     infer_shape=False)
    counter.stop_gradient = True
    return counter


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (reference + Transformer paper)."""
    global_step = _decay_step_counter(1)
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    lr_value = (d_model ** -0.5) * control_flow.min_(a, b)
    return lr_value


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * decay_rate ^ (step / decay_steps), the exponent floored with
    staircase."""
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return ops.scale(_pow_scalar_base(decay_rate, div_res),
                     scale=float(learning_rate))


def _pow_scalar_base(base, exponent_var):
    """base ** exponent_var via exp(log(base) * e)."""
    return ops.exp(ops.scale(exponent_var, scale=math.log(float(base))))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return ops.scale(ops.exp(ops.scale(div_res, scale=-float(decay_rate))),
                     scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    denom = ops.scale(div_res, scale=float(decay_rate), bias=1.0)
    return ops.scale(ops.reciprocal(denom), scale=float(learning_rate))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end) * (1 - step / decay_steps) ^ power + end, the step capped
    at decay_steps, or with cycle decay_steps stretched to the next
    multiple of itself above the step."""
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(global_step / float(decay_steps))
        # an unread zero, as the JAX package emits one (the same program)
        tensor.fill_constant(shape=[1], dtype='float32', value=0.0)
        one = tensor.fill_constant(shape=[1], dtype='float32', value=1.0)
        # at step 0 the multiple is 1, not 0
        div_res = control_flow.max_(div_res, one)
        decay_steps_var = ops.scale(div_res, scale=float(decay_steps))
        frac = global_step / decay_steps_var
    else:
        capped = control_flow.min_(
            global_step,
            tensor.fill_constant(shape=[1], dtype='float32',
                                 value=float(decay_steps)))
        frac = ops.scale(capped, scale=1.0 / float(decay_steps))
    base = ops.scale(frac, scale=-1.0, bias=1.0)  # (1 - t)
    poly = ops.pow(base, factor=float(power))
    return ops.scale(poly, scale=float(learning_rate - end_learning_rate),
                     bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """values[i] while boundaries[i-1] <= step < boundaries[i]: the sum of
    each value times its interval's indicator."""
    assert len(boundaries) + 1 == len(values)
    global_step = _decay_step_counter()
    # an unread fill of the last value, as the JAX package emits one
    tensor.fill_constant(shape=[1], dtype='float32', value=float(values[-1]))
    pieces = []
    prev = None
    for i, b in enumerate(boundaries):
        bound = tensor.fill_constant(shape=[1], dtype='float32',
                                     value=float(b))
        below = tensor.cast(control_flow.less_than(global_step, bound),
                            'float32')
        indicator = below if prev is None else below - prev
        pieces.append(ops.scale(indicator, scale=float(values[i])))
        prev = below
    above = ops.scale(prev, scale=-1.0, bias=1.0)
    pieces.append(ops.scale(above, scale=float(values[-1])))
    return tensor.sums(pieces)


def append_LARS(params_grads, learning_rate, weight_decay):
    """LARS per-layer rates (reference layers/learning_rate_scheduler.py
    :append_LARS): learning_rate * param_lr * ||p|| / (||g|| +
    weight_decay * ||p||), the norms root mean squares as in the JAX
    package; returns one rate Variable per (param, grad)."""
    def _balanced_weight(param_norm, grad_norm):
        if weight_decay == 1.0:
            return grad_norm + param_norm
        return grad_norm + weight_decay * param_norm

    outs = []
    for param, grad in params_grads:
        param_lr = param.optimize_attr['learning_rate']
        param_norm = ops.sqrt(ops.mean(ops.square(param)))
        grad_norm = ops.sqrt(ops.mean(ops.square(grad)))
        outs.append(ops.scale(
            param_norm / _balanced_weight(param_norm, grad_norm),
            scale=float(learning_rate * param_lr)))
    return outs
