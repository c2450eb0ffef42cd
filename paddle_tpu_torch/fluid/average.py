"""WeightedAverage. Parity: reference python/paddle/fluid/average.py; the
port's own copy of the JAX package's fluid/average.py (numpy only)."""
import numpy as np

__all__ = ["WeightedAverage"]


def _is_number_(var):
    return isinstance(var, int) or isinstance(var, float) or \
        (isinstance(var, np.ndarray) and var.shape == (1,))


def _is_number_or_matrix_(var):
    return _is_number_(var) or isinstance(var, np.ndarray)


class WeightedAverage(object):
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix_(value):
            raise ValueError("add(): value must be a number or numpy array")
        if not _is_number_(weight):
            raise ValueError("add(): weight must be a number")
        if self.numerator is None or self.denominator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator is None:
            raise ValueError("eval() before any add()")
        return self.numerator / self.denominator
