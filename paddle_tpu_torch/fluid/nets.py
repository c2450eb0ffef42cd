"""Composite networks. Parity: reference python/paddle/fluid/nets.py and
the JAX package's fluid/nets.py:8, reduced to what models/mnist.py
builds with."""
from . import layers

__all__ = ['simple_img_conv_pool']


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type='max', use_cudnn=True, use_mkldnn=False):
    """conv2d with its activation, then pool2d."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act, use_cudnn=use_cudnn)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         use_cudnn=use_cudnn)
