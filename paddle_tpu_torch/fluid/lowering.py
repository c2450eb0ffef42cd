"""Op lowering registry: Fluid op symbols -> PyTorch.

Parity: the JAX package's fluid/lowering.py (register/get_rule, Ctx,
run_op:253, run_block:273, build-time shape inference :490-586). Each op
type has ONE rule `(ins, attrs, ctx) -> {slot: tensor}` on torch tensors.
The Executor walks a Program eagerly through these rules on its device;
build-time shape inference evaluates the same rules on `meta` tensors
(shapes and dtypes only, no storage), with the dynamic batch dim stood in
by framework.DYN_DIM, so op semantics are defined exactly once.

Sequence (LoD) values, sparse-row gradients and tensor arrays of the JAX
package (SeqValue, SparseRows, ArrayValue) have no counterpart yet.
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
    step."""
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
    """Per-run lowering context: run mode, the torch.device every tensor of
    the run lives on, and the Executor's torch.Generator that random ops
    draw from (None under shape inference)."""

    __slots__ = ('is_test', 'device', 'generator')

    def __init__(self, device, generator=None, is_test=False):
        self.device = device
        self.generator = generator
        self.is_test = is_test


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
    else:
        ins = {slot: [env[v.name] for v in vs]
               for slot, vs in op.inputs.items()}
        outs = get_rule(op.type)(ins, op.attrs, ctx)
    _bind_outputs(op, outs, env)


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
