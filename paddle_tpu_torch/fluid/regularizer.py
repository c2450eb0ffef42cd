"""Weight-decay regularizers.

Parity: reference python/paddle/fluid/regularizer.py and the JAX package's
fluid/regularizer.py: grad-augmentation ops appended before the optimizer
update ops.
"""
from . import framework

__all__ = ['L1Decay', 'L2Decay', 'L1DecayRegularizer', 'L2DecayRegularizer',
           'append_regularization_ops']


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type='scale', inputs={'X': param},
                        outputs={'Out': decay},
                        attrs={'scale': self._coeff,
                               'op_role': framework.ROLE_BACKWARD})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type='sign', inputs={'X': param},
                        outputs={'Out': sign},
                        attrs={'op_role': framework.ROLE_BACKWARD})
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type='scale', inputs={'X': sign},
                        outputs={'Out': decay},
                        attrs={'scale': self._coeff,
                               'op_role': framework.ROLE_BACKWARD})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """reference regularizer.py:append_regularization_ops."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        regularization_term = None
        if param.regularizer is not None:
            regularization_term = param.regularizer(param, grad, grad.block)
        elif regularization is not None:
            regularization_term = regularization(param, grad, grad.block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        new_grad = block.create_var(dtype=param.dtype, shape=param.shape,
                                    name=grad.name + '@REG')
        block.append_op(type='elementwise_add',
                        inputs={'X': grad, 'Y': regularization_term},
                        outputs={'Out': new_grad},
                        attrs={'op_role': framework.ROLE_BACKWARD})
        params_and_grads.append((param, new_grad))
    return params_and_grads


# short aliases, reference regularizer.py end-of-module
L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
