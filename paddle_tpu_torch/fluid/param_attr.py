"""ParamAttr.

Parity: reference python/paddle/fluid/param_attr.py and the JAX package's
fluid/param_attr.py (sharding annotations and WeightNormParamAttr wait for
the slices that need them).
"""
from .initializer import Initializer, Xavier, Constant

__all__ = ['ParamAttr']


class ParamAttr(object):
    def __init__(self,
                 name=None,
                 initializer=None,
                 learning_rate=1.0,
                 regularizer=None,
                 trainable=True,
                 gradient_clip=None,
                 do_model_average=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    def set_default_initializer(self, initializer):
        if initializer is None:
            if self.initializer is None:
                raise ValueError("ParamAttr.initializer is not set")
            return
        if self.initializer is not None:
            return
        self.initializer = initializer

    def set_default_param_initializer(self):
        self.set_default_initializer(Xavier())

    def set_default_bias_initializer(self):
        self.set_default_initializer(Constant(0.0))

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        elif isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        elif isinstance(arg, ParamAttr):
            return arg
        elif isinstance(arg, str):
            return ParamAttr(name=arg)
        elif isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        elif isinstance(arg, bool):
            # False suppresses the parameter entirely (reference
            # param_attr.py:_to_attr returns False -> append_bias_op skips)
            return ParamAttr.to_attr(None) if arg else False
        else:
            raise TypeError("cannot convert %r to ParamAttr" % (arg,))

    def to_kwargs(self, with_initializer=False):
        kwargs = {
            'name': self.name,
            'optimize_attr': {'learning_rate': self.learning_rate},
            'regularizer': self.regularizer,
            'trainable': self.trainable,
            'gradient_clip_attr': self.gradient_clip,
            'do_model_average': self.do_model_average,
        }
        if with_initializer:
            kwargs['initializer'] = self.initializer
        return kwargs
