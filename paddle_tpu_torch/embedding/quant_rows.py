"""Int8 embedding ROW codec: quantized storage, fp32 optimizer moments.

Parity: the JAX package's embedding/quant_rows.py. The delta publisher
(streaming/publish.py) moves table ROWS from the trainer into serving
replicas; row values tolerate int8 (each row carries its own absmax
scale: the per-channel axis-0 scheme of fluid/ops_impl/quant_ops.py,
whose quantize_array is the one definition of the rounding), while the
optimizer MOMENTS that ride next to them in training do not: their
magnitudes span the whole schedule, so moments stay fp32 and only the
VALUE bytes shrink. On the delta push the wire bytes per row go from 4*D
to D + 4.
"""
import numpy as np

from ..fluid.ops_impl.quant_ops import quantize_array

__all__ = ['quantize_rows', 'dequantize_rows', 'row_bytes',
           'ROW_SCALE_BYTES']

# one f32 absmax scale per row rides with the int8 payload
ROW_SCALE_BYTES = 4


def quantize_rows(vals):
    """[N, D] float rows -> (q int8 [N, D], scale f32 [N, 1]) numpy
    arrays with per-row symmetric absmax scales: quant_ops.quantize_array
    (axis=0) on the host (the publisher runs off the step path)."""
    q, scale = quantize_array(np.asarray(vals, np.float32), axis=0)
    return q.numpy(), scale.numpy()


def dequantize_rows(q, scale):
    """Invert quantize_rows: [N, D] int8 + [N, 1] f32 -> f32 rows. The
    round-trip error bound is half a step per element:
    |deq(q(x)) - x| <= max|x_row| / 254."""
    return q.astype(np.float32) * np.asarray(scale, np.float32)


def row_bytes(q, scale):
    """Payload bytes of a quantized row batch (values + scales) — what
    the delta push puts on the wire per table."""
    return int(np.asarray(q).nbytes + np.asarray(scale).nbytes)
