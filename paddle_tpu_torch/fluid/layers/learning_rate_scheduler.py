"""Learning-rate schedules built from graph ops.

Parity: reference layers/learning_rate_scheduler.py and the JAX package's
fluid/layers/learning_rate_scheduler.py:23-51. A schedule appends ops,
driven by the persistable @LR_DECAY_COUNTER@ step var, that compute the lr
the optimizer's update ops read; the Executor runs them every step. The
other schedules of the JAX module (exponential, natural_exp, inverse_time,
polynomial and piecewise decay, append_LARS) need op rules the port does
not have yet (exp, floor, ceil, reciprocal, pow, less_than); they are
listed in ROADMAP.md.
"""
from ..framework import ROLE_LRSCHED
from ..layer_helper import LayerHelper
from ..initializer import Constant
from . import control_flow

__all__ = ['noam_decay']


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
