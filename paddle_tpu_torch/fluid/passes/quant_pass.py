"""Int8 weight quantization as an IR rewrite.

Parity: the JAX package's fluid/passes/quant_pass.py. Two surfaces over
the same three ops (ops_impl/quant_ops.py):

* `run(program, report)`: the pass-pipeline form, gated like the AMP
  rewrite (mark the program with `mark_quant`; the executor's optimize()
  rewrites its clone at every PADDLE_TPU_OPT level). Every eligible op
  with a frozen float32 weight gets explicit ops: `mul` / `matmul`
  weights route through `quantize` -> `dequantize` (the op still takes
  f32), and `lookup_table` becomes `quant_lookup_table`, which gathers
  int8 rows and per-row scales and dequantizes after the gather.

* `quantize_weights(program, scope)`: the offline form for deployment.
  It computes each weight's int8 tensor and per-channel scale once
  (quant_ops.quantize_array, on the weight's device), installs them as
  `W@quant.int8` / `W@quant.scale` persistables in the scope, repoints
  the consumers (mul / matmul through a `dequantize` temp, lookup_table
  to `quant_lookup_table`) and DROPS the unreferenced f32 weight from the
  block, so save_inference_model ships int8 bytes and a Predictor never
  loads the f32 weights. On the card each replay of such a step writes
  the f32 `W@quant.deq` temps into the graph's pool.

Numerics: the symmetric per-channel round trip is within half a step per
element, |deq(q(x)) - x| <= max|x[ch]| / 254; everything outside the
rewritten ops is bit-identical.
"""
from ... import obs
from ..framework import Operator
from . import OP_SEQ_ATTR

__all__ = ['mark_quant', 'is_quant', 'run', 'quantize_weights',
           'QUANT_SLOTS']

_C_REWRITTEN = obs.counter('passes.quant.ops_rewritten')
_C_QDQ = obs.counter('passes.quant.qdq_inserted')
_C_WEIGHTS = obs.counter('passes.quant.weights_quantized')

# op type -> (weight input slot, per-channel axis of that weight).
# Weight-only quantization: activations stay f32, so downstream dtypes
# never change and no eligibility probe is needed (unlike the amp
# rewrite). lookup_table's axis 0 is per ROW (the layout of the embedding
# row codec, embedding/quant_rows.py); matmul weights quantize per OUTPUT
# channel (axis 1 of [K, N]).
QUANT_SLOTS = {
    'mul': ('Y', 1),
    'matmul': ('Y', 1),
    'lookup_table': ('W', 0),
}


def mark_quant(program, ops=None, weight_dtype='int8'):
    """Arm the quant rewrite for this program (the amp.decorate_program
    idiom): optimize() will run the pass on its clone. `ops` optionally
    restricts rewriting to a subset of QUANT_SLOTS op types."""
    if weight_dtype != 'int8':
        raise ValueError('only int8 weight quantization is implemented, '
                         'got %r' % (weight_dtype,))
    program._quant = True
    if ops is not None:
        program._quant_ops = tuple(ops)
    program._bump_version()
    return program


def is_quant(program):
    return bool(getattr(program, '_quant', False))


def _quant_types(program):
    sel = getattr(program, '_quant_ops', None)
    return set(sel) if sel is not None else set(QUANT_SLOTS)


def _weight_target(block, op, types):
    """The (slot, axis, var) to quantize for `op`, or None: the weight
    slot's single input when it is a frozen f32 persistable."""
    if op.type not in types or op.type not in QUANT_SLOTS:
        return None
    slot, axis = QUANT_SLOTS[op.type]
    vs = op.inputs.get(slot)
    if not vs or len(vs) != 1:
        return None
    v = vs[0]
    if not getattr(v, 'persistable', False) or v.dtype != 'float32':
        return None
    return slot, axis, v


def _scale_shape(shape, axis):
    if shape is None:
        return None
    return [int(d) if i == axis else 1 for i, d in enumerate(shape)]


def run(program, report):
    """Rewrite eligible ops in place (program is optimize()'s clone).
    Returns the number of ops rewritten."""
    from . import written_names
    block = program.global_block()
    types = _quant_types(program)
    version = {}           # name -> write version (the block is not SSA)
    qdq_cache = {}         # (name, version) -> (q var, scale var, deq var)
    new_ops = []
    inserted = rewritten = 0
    bw_cache = {}

    def bump(op):
        for n in written_names(program, op, cache=bw_cache):
            version[n] = version.get(n, 0) + 1

    for op in block.ops:
        target = _weight_target(block, op, types)
        if target is None:
            new_ops.append(op)
            bump(op)
            continue
        slot, axis, v = target
        seq = op.attrs.get(OP_SEQ_ATTR, 0)
        callsite = getattr(op, 'callsite', None)
        ck = (v.name, version.get(v.name, 0))
        cached = qdq_cache.get(ck)
        if cached is None:
            qv = block.create_var(
                name='%s@quant.v%d.int8' % (v.name, ck[1]),
                shape=list(v.shape) if v.shape is not None else None,
                dtype='int8', lod_level=v.lod_level)
            sv = block.create_var(
                name='%s@quant.v%d.scale' % (v.name, ck[1]),
                shape=_scale_shape(v.shape, axis),
                dtype='float32', lod_level=0)
            new_ops.append(Operator(
                block, type='quantize', inputs={'X': [v]},
                outputs={'Out': [qv], 'Scale': [sv]},
                attrs={'axis': axis, OP_SEQ_ATTR: seq},
                callsite=callsite))
            cached = [qv, sv, None]
            qdq_cache[ck] = cached
            inserted += 1
        qv, sv, dv = cached
        if op.type == 'lookup_table':
            # gather stays int8-side: rewrite the op itself
            op.type = 'quant_lookup_table'
            op.inputs[slot] = [qv]
            op.inputs['Scale'] = [sv]
        else:
            if dv is None:
                dv = block.create_var(
                    name='%s@quant.v%d.deq' % (v.name, ck[1]),
                    shape=list(v.shape) if v.shape is not None else None,
                    dtype='float32', lod_level=v.lod_level)
                new_ops.append(Operator(
                    block, type='dequantize',
                    inputs={'X': [qv], 'Scale': [sv]},
                    outputs={'Out': [dv]},
                    attrs={OP_SEQ_ATTR: seq}, callsite=callsite))
                cached[2] = dv
                inserted += 1
            op.inputs[slot] = [dv]
        new_ops.append(op)
        bump(op)
        rewritten += 1

    if rewritten or inserted:
        block.ops = new_ops
        program._bump_version()
        _C_REWRITTEN.inc(rewritten)
        _C_QDQ.inc(inserted)
    # quant becomes an IR property of the rewritten clone, exactly the
    # amp pass's flag protocol
    program._quant = False
    program._quant_ir = True
    report.note('quant', ops_rewritten=rewritten, qdq_inserted=inserted)
    return rewritten


def quantize_weights(program, scope, ops=None):
    """Offline weight quantization for deployment (see module
    docstring). Mutates `program` and `scope` in place; returns the
    number of weights quantized. Run on the pruned inference clone
    BEFORE save_inference_model so the artifact ships int8 bytes."""
    from ..ops_impl.quant_ops import quantize_array

    block = program.global_block()
    types = set(ops) if ops is not None else set(QUANT_SLOTS)
    made = {}              # weight name -> (q var, scale var)
    replaced = set()
    new_ops = []
    quantized = 0

    for op in block.ops:
        target = _weight_target(block, op, types)
        if target is None:
            new_ops.append(op)
            continue
        slot, axis, v = target
        val = scope._chain_get(v.name)
        if val is None:
            new_ops.append(op)
            continue
        if v.name not in made:
            q, scale = quantize_array(val, axis=axis)
            qv = block.create_var(
                name=v.name + '@quant.int8',
                shape=list(v.shape) if v.shape is not None else None,
                dtype='int8', lod_level=v.lod_level, persistable=True)
            sv = block.create_var(
                name=v.name + '@quant.scale',
                shape=_scale_shape(v.shape, axis),
                dtype='float32', persistable=True)
            scope.vars[qv.name] = q
            scope.vars[sv.name] = scale
            made[v.name] = (qv, sv)
            quantized += 1
        qv, sv = made[v.name]
        seq = op.attrs.get(OP_SEQ_ATTR, 0) if OP_SEQ_ATTR in op.attrs \
            else None
        if op.type == 'lookup_table':
            op.type = 'quant_lookup_table'
            op.inputs[slot] = [qv]
            op.inputs['Scale'] = [sv]
        else:
            dv = block.vars.get(v.name + '@quant.deq')
            if dv is None:
                dv = block.create_var(
                    name=v.name + '@quant.deq',
                    shape=list(v.shape) if v.shape is not None else None,
                    dtype='float32', lod_level=v.lod_level)
                attrs = {} if seq is None else {OP_SEQ_ATTR: seq}
                new_ops.append(Operator(
                    block, type='dequantize',
                    inputs={'X': [qv], 'Scale': [sv]},
                    outputs={'Out': [dv]},
                    attrs=attrs, callsite=getattr(op, 'callsite', None)))
            op.inputs[slot] = [dv]
        new_ops.append(op)
        replaced.add(v.name)

    if not quantized:
        return 0
    block.ops = new_ops
    # drop f32 weights no block still references: save_inference_model
    # then skips their bytes and the executor never uploads them
    still_used = set()
    for blk in program.blocks:
        for op in blk.ops:
            for n in op.input_arg_names:
                still_used.add(n)
            for n in op.output_arg_names:
                still_used.add(n)
    for name in replaced:
        if name not in still_used and name in block.vars:
            del block.vars[name]
    program._quant_ir = True
    program._bump_version()
    _C_WEIGHTS.inc(quantized)
    return quantized
