"""ParamAttr / WeightNormParamAttr.

Parity: reference python/paddle/fluid/param_attr.py and the JAX package's
fluid/param_attr.py, with its per-dim sharding annotation (a parameter
split over a set_mesh program's data axis is held as each rank's block:
ZeRO-3, fluid/mesh_step.py).
"""
from .initializer import Initializer, Xavier, Constant

__all__ = ['ParamAttr', 'WeightNormParamAttr']


class ParamAttr(object):
    def __init__(self,
                 name=None,
                 initializer=None,
                 learning_rate=1.0,
                 regularizer=None,
                 trainable=True,
                 gradient_clip=None,
                 do_model_average=None,
                 sharding=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        # per-dim mesh-axis names (the JAX :33-38), normalized here so a
        # bad spec fails at the layer call that wrote it
        from .framework import normalize_sharding
        self.sharding = normalize_sharding(sharding)

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
            'sharding': self.sharding,
        }
        if with_initializer:
            kwargs['initializer'] = self.initializer
        return kwargs


class WeightNormParamAttr(ParamAttr):
    """Weight-norm reparameterization attr (reference param_attr.py):
    LayerHelper.create_parameter builds w = v * g / ||v|| from it, the norm
    over every dim but `dim` (all dims when None)."""

    def __init__(self, dim=None, **kwargs):
        super(WeightNormParamAttr, self).__init__(**kwargs)
        self.dim = dim
