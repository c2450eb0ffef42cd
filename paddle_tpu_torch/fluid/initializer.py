"""Parameter initializers: append init ops to the startup program.

Parity: reference python/paddle/fluid/initializer.py and the JAX package's
fluid/initializer.py. Each __call__ appends one op to the var's block
(normally the startup program); the ops draw from the Executor's
torch.Generator when the startup program runs (ops_impl/tensor_ops.py).
"""
import numpy as np

__all__ = ['Constant', 'Uniform', 'Normal', 'Xavier', 'ConstantInitializer',
           'UniformInitializer', 'NormalInitializer', 'XavierInitializer']


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            type='fill_constant', outputs={'Out': var},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'value': float(self._value)},
            infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high, self._seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type='uniform_random', outputs={'Out': var},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'min': self._low, 'max': self._high, 'seed': self._seed},
            infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type='gaussian_random', outputs={'Out': var},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'mean': self._mean, 'std': self._std, 'seed': self._seed},
            infer_shape=False)


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return (shape[0] if shape else 1), (shape[0] if shape else 1)
    fan_in = int(np.prod(shape[1:]))
    fan_out = int(shape[0] * np.prod(shape[2:])) if len(shape) > 2 else shape[1]
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """reference initializer.py XavierInitializer (Glorot)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform, self._fan_in, self._fan_out, self._seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        if self._uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = float(np.sqrt(2.0 / (fi + fo)))
        return NormalInitializer(0.0, std, self._seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
