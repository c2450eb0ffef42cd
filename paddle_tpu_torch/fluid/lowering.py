"""Op lowering registry: Fluid op symbols -> PyTorch.

Parity: the JAX package's fluid/lowering.py (register/get_rule, Ctx,
run_op:253, run_block:273, build-time shape inference :490-586). Each op
type has ONE rule `(ins, attrs, ctx) -> {slot: tensor}` on torch tensors.
The Executor walks a Program eagerly through these rules on its device;
build-time shape inference evaluates the same rules on `meta` tensors
(shapes and dtypes only, no storage), with the dynamic batch dim stood in
by framework.DYN_DIM, so op semantics are defined exactly once.

SeqValue (lowering.py:125-186) is the runtime value of a lod_level > 0
variable: padded data [batch, time, ...] with its lengths. SparseRows
(:189-231) carries the touched-rows gradient of an is_sparse embedding
table. The JAX package's tensor arrays (ArrayValue) have no counterpart
yet.
"""
import torch

from . import core
from .framework import DYN_DIM

_RULES = {}
_CONSTANT_OPS = set()


class NoRuleError(KeyError):
    pass


def register(op_type, constant=False):
    """Register the rule for op_type. constant=True declares that the
    rule's outputs depend on its attrs alone (no inputs, no randomness):
    run_op then evaluates it once per op and device and reuses the result,
    the eager counterpart of XLA folding the constant into the compiled
    step — except where the op writes a persistable (a startup
    initializer): the scope owns that tensor, and the sparse optimizer
    rules update tables and moments in place, so each run hands out a
    fresh copy of the cached result (a device-side copy, which a captured
    CUDA graph can replay)."""
    def deco(fn):
        _RULES[op_type] = fn
        if constant:
            _CONSTANT_OPS.add(op_type)
        return fn
    return deco


def get_rule(op_type):
    try:
        return _RULES[op_type]
    except KeyError:
        raise NoRuleError("no lowering rule for op %r" % op_type)


def has_rule(op_type):
    return op_type in _RULES


class Ctx(object):
    """Per-run lowering context: run mode, AMP (the JAX Ctx's `amp`,
    lowering.py:81-96), the torch.device every tensor of the run lives on,
    and the Executor's torch.Generator that random ops draw from (None
    under shape inference)."""

    __slots__ = ('is_test', 'amp', 'device', 'generator')

    def __init__(self, device, generator=None, is_test=False, amp=False):
        self.device = device
        self.generator = generator
        self.is_test = is_test
        self.amp = amp


def amp_cast(ctx, *xs):
    """Under AMP, cast fp32 matmul / conv / attention operands to bf16 for
    the tensor cores (the JAX :98-104); anything else passes through."""
    if not ctx.amp:
        return xs if len(xs) > 1 else xs[0]
    out = tuple(x.to(torch.bfloat16) if x.dtype == torch.float32 else x
                for x in xs)
    return out if len(out) > 1 else out[0]


class SparseRows(object):
    """Sparse gradient of an embedding table: the rows actually touched
    (the reference's SelectedRows, paddle/fluid/framework/selected_rows.h).

    `ids` int64 [N] are the looked-up row indices (duplicates allowed, in
    lookup order), `rows` [N, D] the per-occurrence gradients; the dense
    gradient they stand for is index_add(zeros(dense_shape), ids, rows).
    The optimizer rules (ops_impl/optim_ops.py) consume it with row
    updates, so the vocab-sized dense @GRAD buffer never exists."""

    __slots__ = ('ids', 'rows', 'dense_shape')

    def __init__(self, ids, rows, dense_shape):
        self.ids = ids
        self.rows = rows
        self.dense_shape = tuple(dense_shape)

    @property
    def dtype(self):
        return self.rows.dtype

    def astype(self, dtype):
        return SparseRows(self.ids, self.rows.to(dtype), self.dense_shape)

    def to_dense(self):
        out = torch.zeros(self.dense_shape, dtype=self.rows.dtype,
                          device=self.rows.device)
        return out.index_add_(0, self.ids, self.rows)


class SeqValue(object):
    """Runtime value of a lod_level > 0 Variable: dense padded data plus
    lengths (the JAX :125-186).

    The reference's LoDTensor stores sequences flattened [total_tokens, d]
    with an offset table (paddle/fluid/framework/lod_tensor.h); here
    `data` is [batch, max_len, ...], so every rule is a masked dense op and
    a captured graph sees static shapes. `lengths` int64 [batch] is the
    innermost level's lengths in rows (the JAX package's are int32; the
    values agree, and int64 is torch's index dtype). Every level above
    the innermost rides in `outer_lengths`, a tuple of int64 vectors,
    outermost first: level k's entries count level k+1's sequences.
    `beam_cap` marks the capacity form of the LoD beam decoder (JAX
    ops_impl/lod_beam.py); no rule of the port makes one yet."""

    __slots__ = ('data', 'lengths', 'outer_lengths', 'beam_cap')

    def __init__(self, data, lengths, outer_lengths=None, beam_cap=False):
        self.data = data
        self.lengths = lengths
        if outer_lengths is not None and not isinstance(outer_lengths,
                                                        tuple):
            outer_lengths = tuple(outer_lengths) \
                if isinstance(outer_lengths, list) else (outer_lengths,)
        self.outer_lengths = outer_lengths or None
        self.beam_cap = bool(beam_cap)

    def mask(self, dtype=torch.float32):
        """[batch, max_len] validity mask, on the data's device."""
        steps = torch.arange(self.data.shape[1], device=self.lengths.device)
        return (steps[None, :] < self.lengths[:, None]).to(dtype)

    def with_leaves(self, leaves):
        """A SeqValue of this one's structure over `leaves` (as leaves_of
        orders them)."""
        leaves = tuple(leaves)
        return SeqValue(leaves[0], leaves[1], leaves[2:] or None,
                        beam_cap=self.beam_cap)


def data_of(v):
    return v.data if isinstance(v, SeqValue) else v


def like(template, new_data):
    """Wrap new_data with template's sequence structure (if any)."""
    if isinstance(template, SeqValue):
        return SeqValue(new_data, template.lengths, template.outer_lengths,
                        beam_cap=template.beam_cap)
    return new_data


def first_seq(*vals):
    for v in vals:
        if isinstance(v, SeqValue):
            return v
    return None


def leaves_of(v):
    """The tensors of a value: a SeqValue's (data, lengths,
    *outer_lengths), or (v,)."""
    if isinstance(v, SeqValue):
        return (v.data, v.lengths) + tuple(v.outer_lengths or ())
    return (v,)


def map_value(fn, v):
    """fn over every tensor of v (a SeqValue's leaves, or v itself)."""
    if isinstance(v, SeqValue):
        return v.with_leaves(fn(t) for t in leaves_of(v))
    return fn(v)


def run_op(op, env, ctx):
    """Resolve an op's inputs from env, apply its rule, bind outputs."""
    if op.type in _CONSTANT_OPS:
        cache = op.__dict__.setdefault('_constant_outs', {})
        outs = cache.get(ctx.device)
        if outs is None:
            outs = cache[ctx.device] = get_rule(op.type)({}, op.attrs, ctx)
        if _writes_persistable(op):
            outs = {slot: [v.clone() for v in vals]
                    if isinstance(vals, (list, tuple)) else vals.clone()
                    for slot, vals in outs.items()}
    else:
        ins = {slot: [env[v.name] for v in vs]
               for slot, vs in op.inputs.items()}
        outs = get_rule(op.type)(ins, op.attrs, ctx)
    _bind_outputs(op, outs, env)


def _writes_persistable(op):
    return any(v.persistable for vs in op.outputs.values() for v in vs)


def run_block(block, env, ctx):
    """Execute every op of a block against env, in place."""
    for op in block.ops:
        run_op(op, env, ctx)


def _bind_outputs(op, outs, env):
    for slot, vs in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for var, val in zip(vs, vals):
            if val is not None:
                env[var.name] = val


def spec_of(var):
    """Build-time abstract value of a Variable: a meta tensor of its shape
    (the dynamic dims stood in by DYN_DIM) and dtype, a SeqValue of meta
    tensors for a lod_level > 0 var (the JAX :490-506), or None when the
    shape is undeclared."""
    if var.shape is None:
        return None
    shape = tuple(DYN_DIM if d == -1 else d for d in var.shape)
    s = torch.empty(shape, dtype=core.torch_dtype(var.dtype), device='meta')
    if var.lod_level and var.lod_level > 0:
        # padded layout [batch, time, ...]: the shape carries both dynamic
        # dims (layers/io.py:data)
        lens = torch.empty((shape[0],), dtype=torch.int64, device='meta')
        if var.lod_level > 1:
            return SeqValue(s, lens, lens)
        return SeqValue(s, lens)
    return s


def shape_from_spec(t):
    """Declared-shape view of an inferred tensor: DYN_DIM is prime, so any
    multiple of it can only have come from the dynamic batch dim (merged
    by a reshape) and maps back to -1."""
    return tuple(-1 if d % DYN_DIM == 0 and d > 0 else int(d)
                 for d in t.shape)


def infer_op_shapes(op):
    """Build-time shape/dtype inference by evaluating the rule on meta
    tensors; replaces the reference's per-op C++ InferShape functions.
    An op with an undeclared input shape keeps its declared output shapes,
    as in the JAX package; a rule that raises on declared shapes is a bug
    and propagates."""
    ins = {slot: [spec_of(v) for v in vs] for slot, vs in op.inputs.items()}
    if any(s is None for vs in ins.values() for s in vs):
        return
    # a sequence input enters without its outer levels, as the JAX
    # abstract_eval (:509-531) re-wraps it: the declared shapes of a
    # program are the JAX package's
    ins = {slot: [SeqValue(s.data, s.lengths) if isinstance(s, SeqValue)
                  else s for s in vs] for slot, vs in ins.items()}
    ctx = Ctx(torch.device('meta'),
              is_test=bool(op.attrs.get('is_test', False)))
    outs = get_rule(op.type)(ins, op.attrs, ctx)
    for slot, vs in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for var, val in zip(vs, vals):
            if val is None:
                continue
            spec = data_of(val)
            var.shape = shape_from_spec(spec)
            var.dtype = core.convert_dtype(spec.dtype)
            if isinstance(val, SeqValue) and var.lod_level == 0:
                var.lod_level = 1
