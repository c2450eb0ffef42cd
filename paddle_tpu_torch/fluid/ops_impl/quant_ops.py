"""Quantization op rules: explicit int8 <-> float boundaries in the IR.

Parity: the JAX package's fluid/ops_impl/quant_ops.py (quantize_array
:34, the rules quantize, dequantize and quant_lookup_table :45-88); the
reference grew fake_quantize / fake_dequantize operators for its slim
tooling. The quant pass (fluid/passes/quant_pass.py) inserts these three
pure rules, so every precision change is an op of the Program, and
constant folding can evaluate a `quantize` of a frozen weight through the
rule itself.

Scheme: symmetric linear int8, per-channel absmax scales,
`scale[ch] = max|x[ch]| / 127` (floored so an all-zero channel stays
finite), `q = clip(round(x / scale), -127, 127)`. torch.round and
jnp.round both round half to even, and the divisions (each of two
tensors, so the card divides too) and the floor are the same float32
operations, so q and the scales are the JAX package's bit for bit, on
the CPU and on the card. Scales keep their reduced axes ([V, 1] for a row-quantized
table, [1, N] for a mul / matmul weight), so dequantize is a broadcast
multiply and the scales ship as ordinary persistables.
"""
import torch

from ..lowering import register, data_of, like

__all__ = ['quantize_array', 'SCALE_FLOOR', 'QMAX']

# absmax floor: keeps all-zero channels' scales finite; a zero row's
# round trip stays exactly zero because q is 0 there anyway
SCALE_FLOOR = 1e-12
QMAX = 127.0


def quantize_array(x, axis=0):
    """(q int8, scale f32 keepdims) for per-channel symmetric absmax
    quantization along `axis`, on x's device (a numpy array goes to a CPU
    tensor). Shared by the rule, the offline weight quantizer
    (passes.quant_pass.quantize_weights) and the embedding row codec
    (embedding.quant_rows): one definition of the rounding."""
    x = torch.as_tensor(x).to(torch.float32)
    axes = tuple(a for a in range(x.ndim) if a != axis % max(x.ndim, 1))
    amax = torch.amax(x.abs(), dim=axes, keepdim=True) if axes \
        else x.abs()
    # QMAX as a tensor on x's device: torch divides a CUDA tensor by a
    # Python scalar as a product with its reciprocal, one ulp off the
    # quotient jnp and the CPU compute
    qmax = torch.full((), QMAX, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(amax / qmax, SCALE_FLOOR)
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale.to(torch.float32)


@register('quantize')
def _quantize(ins, attrs, ctx):
    q, scale = quantize_array(data_of(ins['X'][0]),
                              axis=int(attrs.get('axis', 0)))
    return {'Out': q, 'Scale': scale}


@register('dequantize')
def _dequantize(ins, attrs, ctx):
    q = data_of(ins['X'][0])
    scale = data_of(ins['Scale'][0])
    return {'Out': q.to(torch.float32) * scale}


@register('quant_lookup_table')
def _quant_lookup_table(ins, attrs, ctx):
    """lookup_table over an int8 row-quantized table: gather the int8 rows
    AND their [V, 1] scales by id and dequantize after the gather, so the
    fp32 [V, D] table never exists. The ids follow jnp.take's default
    mode, as the JAX rule gathers: an id in [-V, 0) counts from the end,
    any other id outside [0, V) reads the int8 fill (-128) times a NaN
    scale, a row of NaN; all on the device, with no host check.
    padding_idx zeroes the row through its SCALE, as the JAX rule does."""
    w = data_of(ins['W'][0])                         # int8 [V, D]
    scale = data_of(ins['Scale'][0])                 # f32 [V, 1]
    ids_v = ins['Ids'][0]
    ids = data_of(ids_v).long()
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    n = w.shape[0]
    pad = attrs.get('padding_idx')
    if pad is not None and 0 <= pad < n:
        # a fill of one row: no index tensor copied from the host
        scale = scale.clone()
        scale[pad:pad + 1].fill_(0.0)
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    flat = ids.clamp(0, n - 1).reshape(-1)
    rows = w.index_select(0, flat).to(torch.float32)
    row_scale = scale.index_select(0, flat)
    out = (rows * row_scale).reshape(tuple(ids.shape) + tuple(w.shape[1:]))
    out = torch.where(valid.reshape(tuple(ids.shape) + (1,) * (w.ndim - 1)),
                      out, torch.full_like(out, float('nan')))
    from .lod_beam import is_beam_form
    if is_beam_form(ids_v) and out.ndim == ids.ndim + 1:
        out = out[:, None]
    return {'Out': like(ids_v, out)}
