"""Tensor creation / manipulation rules.

Parity: the JAX package's fluid/ops_impl/tensor_ops.py (reference
paddle/fluid/operators/{fill_constant,fill_constant_batch_size_like,cast,
reshape,transpose,one_hot,assign_value,uniform_random,gaussian_random,
truncated_gaussian_random,shape,squeeze,unsqueeze,split,stack,flatten,pad,
crop,slice,gather,expand,scatter,arg_min_max,argsort,reverse,multiplex,
random_crop,label_smooth,top_k}_op.*). Random ops draw from the Executor's
torch.Generator (a captured step's graph registers it, so each replay
draws anew), so they give other numbers than jax.random from the same
seed, with the same distribution.

Indices out of range follow the JAX rules' gather and scatter modes, on
the device and without a host check (a captured step cannot wait for
one, and an out-of-range index on the card is a device-side assert):
gather wraps [-n, 0) and fills NaN (an integer dtype's minimum) past n,
scatter wraps [-n, 0) and drops the rest, multiplex wraps and clamps.
`is_empty` waits for the control-flow slice of the port.
"""
import math

import numpy as np
import torch

from ..core import torch_dtype
from ..lowering import SeqValue, register, data_of, like, first_seq
from .lod_beam import top_k_lower_index


@register('fill_constant', constant=True)
def _fill_constant(ins, attrs, ctx):
    return {'Out': torch.full(tuple(attrs['shape']), attrs['value'],
                              dtype=torch_dtype(attrs.get('dtype', 'float32')),
                              device=ctx.device)}


def _uniform(shape, attrs, ctx):
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.uniform_(attrs.get('min', -1.0), attrs.get('max', 1.0),
                 generator=ctx.generator)
    return {'Out': out.to(torch_dtype(attrs.get('dtype', 'float32')))}


def _gaussian(shape, attrs, ctx):
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.normal_(attrs.get('mean', 0.0), attrs.get('std', 1.0),
                generator=ctx.generator)
    return {'Out': out.to(torch_dtype(attrs.get('dtype', 'float32')))}


@register('uniform_random')
def _uniform_random(ins, attrs, ctx):
    return _uniform(tuple(attrs['shape']), attrs, ctx)


@register('gaussian_random')
def _gaussian_random(ins, attrs, ctx):
    return _gaussian(tuple(attrs['shape']), attrs, ctx)


@register('assign_value', constant=True)
def _assign_value(ins, attrs, ctx):
    vals = np.asarray(attrs['values'],
                      dtype=attrs.get('dtype', 'float32')).reshape(
                          attrs['shape'])
    out = torch.from_numpy(vals)
    if ctx.device.type == 'cuda':
        # from pinned memory, without a host sync (a pageable copy waits)
        out = out.pin_memory().to(ctx.device, non_blocking=True)
    return {'Out': out.to(ctx.device)}


@register('cast')
def _cast(ins, attrs, ctx):
    x = ins['X'][0]
    return {'Out': like(x, data_of(x).to(torch_dtype(attrs['out_dtype'])))}


@register('increment')
def _increment(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    # the step in x's dtype, as a 0-dim CPU tensor: a scalar operand on any
    # device, with no host-to-device copy
    return {'Out': x + torch.tensor(attrs.get('step', 1.0), dtype=x.dtype)}


@register('is_empty')
def _is_empty(ins, attrs, ctx):
    """A 0-d bool (the JAX :312-320). On a capacity-form beam value it is
    a device-side test, every source pruned (the book decoder's stop
    condition); on any other value the element count, known from the
    shape."""
    from .lod_beam import is_beam_form, is_empty_beam
    x = ins['X'][0]
    if is_beam_form(x):
        return {'Out': is_empty_beam(x)}
    d = data_of(x)
    return {'Out': torch.full((), d.numel() == 0, dtype=torch.bool,
                              device=d.device)}


@register('assign')
def _assign(ins, attrs, ctx):
    return {'Out': ins['X'][0]}


@register('reshape', best_effort_shapes=True)
def _reshape(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    # Fluid semantics (operators/reshape_op.cc): 0 means "copy input dim",
    # one -1 is inferred
    out_shape = [x.shape[i] if int(d) == 0 else int(d)
                 for i, d in enumerate(attrs['shape'])]
    return {'Out': x.reshape(out_shape)}


@register('concat')
def _concat(ins, attrs, ctx):
    """torch.cat; over sequences as the JAX rule (:89-114): along the
    batch (axis 0) of all-sequence inputs the lengths are concatenated,
    along the time axis (1) they add up (exact when every input but the
    last is full length, as the JAX rule says), along a feature axis the
    first sequence's lengths carry over; any other mix is dense."""
    vs = ins['X']
    axis = attrs.get('axis', 0)
    out = torch.cat([data_of(v) for v in vs], dim=axis)
    seq = first_seq(*vs)
    if seq is None:
        return {'Out': out}
    if all(isinstance(v, SeqValue) for v in vs):
        if axis == 0:
            return {'Out': SeqValue(out, torch.cat([v.lengths for v in vs]))}
        if axis == 1:
            lens = vs[0].lengths
            for v in vs[1:]:
                lens = lens + v.lengths
            return {'Out': SeqValue(out, lens)}
    if axis in (0, 1):
        return {'Out': out}
    return {'Out': like(seq, out)}


@register('transpose')
def _transpose(ins, attrs, ctx):
    return {'Out': data_of(ins['X'][0]).permute(*attrs['axis'])}


@register('one_hot')
def _one_hot(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    if x.ndim >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    # comparison, not F.one_hot: an out-of-range id (e.g. -1) gives an
    # all-zero row, as jax.nn.one_hot does, instead of raising
    classes = torch.arange(attrs['depth'], device=x.device)
    out = (x.long().unsqueeze(-1) == classes).to(torch.float32)
    return {'Out': like(ins['X'][0], out)}


@register('label_smooth')
def _label_smooth(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    eps = attrs.get('epsilon', 0.0)
    if ins.get('PriorDist'):
        out = (1 - eps) * x + eps * data_of(ins['PriorDist'][0])
    else:
        out = (1 - eps) * x + eps / x.shape[-1]
    return {'Out': like(ins['X'][0], out)}


@register('top_k')
def _top_k(ins, attrs, ctx):
    """The k largest entries of each row, equal values in index order as
    lax.top_k gives them (a stable sort: torch.topk promises no order among
    equal values on the card); ids int64."""
    vals, idx = top_k_lower_index(data_of(ins['X'][0]), attrs['k'])
    return {'Out': vals, 'Indices': idx}


def _like_shape(ins, attrs):
    """attrs['shape'] with output_dim_idx taken from the Input's
    input_dim_idx (the *_batch_size_like ops)."""
    shape = list(attrs['shape'])
    shape[attrs.get('output_dim_idx', 0)] = \
        data_of(ins['Input'][0]).shape[attrs.get('input_dim_idx', 0)]
    return tuple(shape)


@register('fill_constant_batch_size_like')
def _fill_constant_bsl(ins, attrs, ctx):
    return {'Out': torch.full(_like_shape(ins, attrs), attrs['value'],
                              dtype=torch_dtype(attrs.get('dtype',
                                                          'float32')),
                              device=ctx.device)}


@register('uniform_random_batch_size_like')
def _uniform_random_bsl(ins, attrs, ctx):
    return _uniform(_like_shape(ins, attrs), attrs, ctx)


@register('gaussian_random_batch_size_like')
def _gaussian_random_bsl(ins, attrs, ctx):
    return _gaussian(_like_shape(ins, attrs), attrs, ctx)


@register('truncated_gaussian_random')
def _truncated_gaussian_random(ins, attrs, ctx):
    """mean + std * N(0, 1) truncated to [-2, 2]: sqrt(2) * erfinv(u) of u
    uniform between erf(-sqrt(2)) and erf(sqrt(2)), as
    jax.random.truncated_normal draws it."""
    bound = math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(tuple(attrs['shape']), dtype=torch.float32,
                    device=ctx.device)
    u.uniform_(-bound, bound, generator=ctx.generator)
    z = (math.sqrt(2.0) * torch.erfinv(u)).clamp(-2.0, 2.0)
    out = attrs.get('mean', 0.0) + attrs.get('std', 1.0) * z
    return {'Out': out.to(torch_dtype(attrs.get('dtype', 'float32')))}


# shape's value on the card per (device, shape), copied in once, eagerly
# (a step's warm-up does it), and cloned on the device at each run: a host
# copy captured into a step would keep the address of a pinned block that
# is freed when the rule returns, and a replay would read what the block
# holds by then
_SHAPE_VALUES = {}


@register('shape')
def _shape(ins, attrs, ctx):
    shape = tuple(data_of(ins['Input'][0]).shape)
    if ctx.device.type != 'cuda':
        return {'Out': torch.tensor(shape, dtype=torch.int32)}
    value = _SHAPE_VALUES.get((ctx.device, shape))
    if value is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError('shape: %r first seen inside a capture'
                               % (shape,))
        # from pinned memory, without a host sync (a pageable copy waits)
        value = _SHAPE_VALUES[ctx.device, shape] = torch.tensor(
            shape, dtype=torch.int32).pin_memory().to(ctx.device,
                                                      non_blocking=True)
    return {'Out': value.clone()}


@register('squeeze')
def _squeeze(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    axes = attrs.get('axes')
    return {'Out': torch.squeeze(x, dim=tuple(axes)) if axes
            else torch.squeeze(x)}


@register('unsqueeze')
def _unsqueeze(ins, attrs, ctx):
    out = data_of(ins['X'][0])
    for a in sorted(attrs['axes']):
        out = out.unsqueeze(a)
    return {'Out': out}


@register('split')
def _split(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    axis = attrs.get('axis', -1)
    sections = attrs.get('sections')
    if sections:
        # split points at the sections' running sums, as jnp.split: the
        # last piece takes the rest of the dim
        return {'Out': list(torch.tensor_split(
            x, np.cumsum(sections)[:-1].tolist(), dim=axis))}
    num = attrs.get('num', 0)
    if x.shape[axis] % num:
        raise ValueError('split: dim %d of size %d does not divide into %d'
                         % (axis, x.shape[axis], num))
    return {'Out': list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register('stack')
def _stack(ins, attrs, ctx):
    return {'Y': torch.stack([data_of(v) for v in ins['X']],
                             dim=attrs.get('axis', 0))}


@register('flatten')
def _flatten(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    axis = attrs.get('axis', 1)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return {'Out': x.reshape(lead, -1)}


@register('pad')
def _pad(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    p = attrs['paddings']
    # F.pad lists the last dim first
    pads = [q for i in reversed(range(x.ndim)) for q in (p[2 * i],
                                                         p[2 * i + 1])]
    return {'Out': torch.nn.functional.pad(
        x, pads, value=attrs.get('pad_value', 0.0))}


def _window(x, starts, sizes):
    """x[starts : starts + sizes] with each start clamped so the window
    fits, as lax.dynamic_slice clamps it."""
    for d, (s, n) in enumerate(zip(starts, sizes)):
        s = min(max(int(s), 0), x.shape[d] - n)
        x = x.narrow(d, s, n)
    return x


@register('crop')
def _crop(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    offsets = attrs.get('offsets')
    shape = attrs.get('shape')
    if ins.get('Y'):
        shape = data_of(ins['Y'][0]).shape
    # a -1 entry means "from the offset to the end of that dim"
    shape = [x.shape[i] - offsets[i] if s == -1 else s
             for i, s in enumerate(shape)]
    return {'Out': _window(x, offsets, shape)}


@register('slice')
def _slice(ins, attrs, ctx):
    x = data_of(ins['Input'][0])
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs['axes'], attrs['starts'], attrs['ends']):
        dim = x.shape[a]
        s2 = s + dim if s < 0 else min(s, dim)
        e2 = e + dim if e < 0 else min(e, dim)
        idx[a] = slice(s2, e2)
    return {'Out': x[tuple(idx)]}


def _wrap(idx, n):
    return torch.where(idx < 0, idx + n, idx)


def _fill_of(x):
    """jnp.take's fill for an out-of-range index: NaN for a float, the
    dtype's minimum for an integer."""
    if x.is_floating_point():
        return float('nan')
    if x.dtype == torch.bool:
        return True
    return torch.iinfo(x.dtype).min


def take_rows(x, index):
    """jnp.take(x, index, axis=0) in its default mode: [-n, 0) wraps, an
    index outside [-n, n) gives the fill; shape index.shape +
    x.shape[1:]. Wrapped, clamped and selected on the device."""
    n = x.shape[0]
    idx = _wrap(index.long(), n)
    rows = x.index_select(0, idx.reshape(-1).clamp(0, n - 1)).reshape(
        tuple(idx.shape) + tuple(x.shape[1:]))
    valid = ((idx >= 0) & (idx < n)).reshape(
        tuple(idx.shape) + (1,) * (x.ndim - 1))
    return torch.where(valid, rows, _fill_of(x))


@register('gather')
def _gather(ins, attrs, ctx):
    return {'Out': take_rows(data_of(ins['X'][0]),
                             data_of(ins['Index'][0]))}


@register('expand')
def _expand(ins, attrs, ctx):
    """reference operators/expand_op.cc: tile each dim by expand_times."""
    return {'Out': torch.tile(data_of(ins['X'][0]),
                              tuple(attrs['expand_times']))}


@register('scatter')
def _scatter(ins, attrs, ctx):
    """x.at[ids].set(updates): [-n, 0) wraps, other ids outside [0, n) are
    dropped, and of duplicate ids the last occurrence wins. index_put_ on
    the card leaves a duplicate's winner undefined, so the winner of each
    row is picked first (an amax of occurrence positions), then every row
    gathers its update or keeps x: no host sync, and the gradient reaches
    each winning update once."""
    x = data_of(ins['X'][0])
    n = x.shape[0]
    ids = _wrap(data_of(ins['Ids'][0]).long().reshape(-1), n)
    upd = data_of(ins['Updates'][0]).reshape((-1,) + tuple(x.shape[1:]))
    valid = (ids >= 0) & (ids < n)
    pos = torch.arange(ids.shape[0], device=ids.device)
    # invalid ids land in a spare slot n, which is dropped
    winner = torch.full((n + 1,), -1, dtype=torch.long, device=ids.device)
    winner = winner.scatter_reduce(0, torch.where(valid, ids, n), pos,
                                   reduce='amax')[:n]
    taken = upd.index_select(0, winner.clamp(min=0))
    hit = (winner >= 0).reshape((n,) + (1,) * (x.ndim - 1))
    return {'Out': torch.where(hit, taken.to(x.dtype), x)}


@register('arg_min')
def _arg_min(ins, attrs, ctx):
    return {'Out': torch.argmin(data_of(ins['X'][0]),
                                dim=attrs.get('axis', 0))}


@register('arg_max')
def _arg_max(ins, attrs, ctx):
    return {'Out': torch.argmax(data_of(ins['X'][0]),
                                dim=attrs.get('axis', 0))}


@register('argsort')
def _argsort(ins, attrs, ctx):
    """A stable ascending sort, NaN last and -0.0 equal to +0.0, as
    jnp.sort and jnp.argsort order them; ids int64."""
    vals, idx = torch.sort(data_of(ins['X'][0]), dim=attrs.get('axis', -1),
                           stable=True)
    return {'Out': vals, 'Indices': idx}


@register('reverse')
def _reverse(ins, attrs, ctx):
    axes = attrs['axis']
    if not isinstance(axes, (list, tuple)):
        axes = [axes]
    return {'Out': torch.flip(data_of(ins['X'][0]), dims=tuple(axes))}


@register('multiplex')
def _multiplex(ins, attrs, ctx):
    """Row i of X[Ids[i]]; an id in [-n, 0) wraps and any other outside
    [0, n) is clamped, as JAX's __getitem__ gathers."""
    xs = torch.stack([data_of(v) for v in ins['X']], dim=0)  # [n, B, ...]
    n = xs.shape[0]
    ids = _wrap(data_of(ins['Ids'][0]).long().reshape(-1), n).clamp(0, n - 1)
    return {'Out': xs[ids, torch.arange(ids.shape[0], device=ids.device)]}


@register('random_crop')
def _random_crop(ins, attrs, ctx):
    """One window of attrs['shape'] over the trailing dims, its start drawn
    uniformly on the device for each dim (the same for the whole batch, as
    the JAX rule draws it), gathered by index_select: no host sync."""
    x = data_of(ins['X'][0])
    shape = attrs['shape']
    lead = x.ndim - len(shape)
    for i, s in enumerate(shape):
        d = lead + i
        start = torch.randint(0, max(x.shape[d] - s, 0) + 1, (1,),
                              generator=ctx.generator, device=x.device)
        x = x.index_select(d, start + torch.arange(s, device=x.device))
    return {'Out': x}
