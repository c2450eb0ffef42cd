"""IO layers. Parity: reference layers/io.py (the `data` layer)."""
from ..layer_helper import LayerHelper
from ..core import convert_dtype

__all__ = ['data']


def data(name, shape, append_batch_size=True, dtype='float32', lod_level=0,
         type=None, stop_gradient=True):
    """reference layers/io.py:data."""
    helper = LayerHelper('data', name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    if lod_level and lod_level > 0:
        # padded layout: sequences are dense [batch, time, ...], so the
        # declared fluid shape gains a dynamic time axis
        shape = [shape[0], -1] + shape[1:]
    return helper.create_global_variable(
        name=name, shape=shape, dtype=convert_dtype(dtype),
        lod_level=lod_level, stop_gradient=stop_gradient, is_data=True)
