"""Parameter initializers: append init ops to the startup program.

Parity: reference python/paddle/fluid/initializer.py and the JAX package's
fluid/initializer.py (Constant, Uniform, Normal, TruncatedNormal, Xavier,
MSRA, Bilinear, NumpyArrayInitializer). Each __call__ appends one op to the
var's block (normally the startup program); the random ones draw from the
Executor's torch.Generator when the startup program runs, the others
(Bilinear, NumpyArrayInitializer) append assign_value with their values
(ops_impl/tensor_ops.py).

`init_on_cpu` / `force_init_on_cpu` keep the reference's flag and, as in
the JAX package, nothing reads it: a startup program runs where its
Executor runs, and never moves a tensor to the host on the card's path.
"""
import contextlib

import numpy as np

__all__ = [
    'Constant', 'Uniform', 'Normal', 'Xavier', 'Bilinear', 'MSRA',
    'force_init_on_cpu', 'init_on_cpu', 'ConstantInitializer',
    'UniformInitializer', 'NormalInitializer', 'XavierInitializer',
    'BilinearInitializer', 'MSRAInitializer', 'TruncatedNormal',
    'TruncatedNormalInitializer', 'NumpyArrayInitializer',
]

_force_init_on_cpu_ = False


def force_init_on_cpu():
    """The flag init_on_cpu sets (read by nothing)."""
    return _force_init_on_cpu_


@contextlib.contextmanager
def init_on_cpu():
    global _force_init_on_cpu_
    prev = _force_init_on_cpu_
    _force_init_on_cpu_ = True
    try:
        yield
    finally:
        _force_init_on_cpu_ = prev


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


class TruncatedNormalInitializer(Initializer):
    """mean + std N(0, 1) truncated to [-2, 2] (the truncated_gaussian_random
    rule): the truncated law's std is 0.8796 std."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type='truncated_gaussian_random', outputs={'Out': var},
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


class MSRAInitializer(Initializer):
    """reference initializer.py MSRAInitializer (He): uniform in
    [-sqrt(6 / fan_in), sqrt(6 / fan_in)] or normal of std
    sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform, self._fan_in, self._seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self._fan_in if self._fan_in is not None else fi
        if self._uniform:
            limit = float(np.sqrt(6.0 / fi))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = float(np.sqrt(2.0 / fi))
        return NormalInitializer(0.0, std, self._seed)(var, block)


def _assign(var, block, values, shape, dtype):
    return block.append_op(
        type='assign_value', outputs={'Out': var},
        attrs={'shape': list(shape), 'dtype': dtype,
               'values': values.reshape(-1).tolist()},
        infer_shape=False)


class BilinearInitializer(Initializer):
    """The bilinear upsampling filter of a conv2d_transpose (reference
    initializer.py BilinearInitializer): for a [C_in, C_out, K, K] filter
    of factor f = ceil(K / 2), each K x K kernel is
    (1 - |x / f - c|)(1 - |y / f - c|), c = (2f - 1 - f % 2) / (2f)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("bilinear init needs a 4-D filter")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype='float32')
        idx = np.arange(int(np.prod(shape)))
        x = idx % shape[3]
        y = (idx // shape[3]) % shape[2]
        weight.flat[idx] = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        return _assign(var, block, weight, shape, var.dtype)


class NumpyArrayInitializer(Initializer):
    """The var set to a given array, of its own shape and dtype."""

    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block):
        return _assign(var, block, self._value, self._value.shape,
                       str(self._value.dtype))


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
