"""Op lowering registry: Fluid op symbols -> PyTorch.

Parity: the JAX package's fluid/lowering.py (register/get_rule, Ctx,
run_op:253, run_block:273, build-time shape inference :490-586). Each op
type has ONE rule `(ins, attrs, ctx) -> {slot: tensor}` on torch tensors.
The Executor walks a Program eagerly through these rules on its device;
build-time shape inference evaluates the same rules on `meta` tensors
(shapes and dtypes only, no storage), with the dynamic batch dim stood in
by framework.DYN_DIM, so op semantics are defined exactly once.

SparseRows (lowering.py:189-231) carries the touched-rows gradient of an
is_sparse embedding table. Sequence (LoD) values and tensor arrays of the
JAX package (SeqValue, ArrayValue) have no counterpart yet.
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


def data_of(v):
    return v


def like(template, new_data):
    """Wrap new_data with template's sequence structure — the identity
    until the port carries sequence values."""
    return new_data


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
    (the dynamic batch dim stood in by DYN_DIM) and dtype, or None when
    the shape is undeclared."""
    if var.shape is None:
        return None
    shape = tuple(DYN_DIM if d == -1 else d for d in var.shape)
    return torch.empty(shape, dtype=core.torch_dtype(var.dtype),
                       device='meta')


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
            var.shape = shape_from_spec(val)
            var.dtype = core.convert_dtype(val.dtype)
