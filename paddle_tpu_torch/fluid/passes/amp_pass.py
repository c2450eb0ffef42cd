"""AMP as an IR rewrite: explicit casts instead of casts inside the rules.

Parity: the JAX package's fluid/passes/amp_pass.py. Runtime AMP
(`lowering.amp_cast`, armed by `ctx.amp`) casts the float32 operands of
mul / matmul / conv2d / flash_attention to bfloat16 inside the rule,
where the Program cannot show it. This pass makes the same decision an
op of the Program: for each eligible op it inserts `cast` ops (f32 ->
bf16) in front of the op's float operands, repoints the op at the cast
temps, and where the rule's output is bf16 where the var declared f32,
routes the op through a bf16 temp and casts back to f32. The rewritten
program runs with `ctx.amp` OFF (`program._amp_ir`): its bf16 operands
reach `_Bf16Product` (math_ops) and the attention kernels' bf16 variants
by their dtype.

Numerics against runtime AMP: a rewritten op's result passes through one
more f32 -> bf16 rounding at the region boundary (runtime AMP gives
mul / matmul an fp32 result inside the rule). The difference is at most
one bf16 ulp of the op's output; everything outside the rewritten ops is
bit-identical.

Eligibility is proved per op by evaluating its rule on bf16 `meta`
tensors (lowering.abstract_eval, the build-time shape inference; the JAX
package uses jax.eval_shape): where that fails, the op stays in f32 and
is counted as skipped.
"""
import torch

from ... import obs
from .. import lowering
from ..framework import Operator
from . import OP_SEQ_ATTR

__all__ = ['run', 'AMP_SLOTS']

_C_CASTS = obs.counter('passes.amp.casts_inserted')
_C_REWRITTEN = obs.counter('passes.amp.ops_rewritten')

# op type -> input slots runtime amp_cast covers (None = every slot; the
# JAX package's moe_mlp, which the port does not have yet, casts its whole
# bundle)
AMP_SLOTS = {
    'mul': ('X', 'Y'),
    'matmul': ('X', 'Y'),
    'conv2d': ('Input', 'Filter'),
    'flash_attention': ('Q', 'K', 'V'),
    'moe_mlp': None,
}


def _bf16_spec(spec):
    if isinstance(spec, lowering.SeqValue):
        return lowering.SeqValue(_bf16_spec(spec.data), spec.lengths,
                                 spec.outer_lengths)
    return torch.empty(tuple(spec.shape), dtype=torch.bfloat16,
                       device='meta')


def _cast_op(block, src, dst, dtype, seq_attr):
    return Operator(block, type='cast', inputs={'X': [src]},
                    outputs={'Out': [dst]},
                    attrs={'out_dtype': dtype, OP_SEQ_ATTR: seq_attr},
                    callsite=getattr(src.op, 'callsite', None))


def run(program, report):
    """Rewrite AMP regions in place (program is optimize()'s clone).
    Returns the number of ops rewritten."""
    from . import written_names
    block = program.global_block()
    version = {}            # name -> write version (the block is not SSA)
    cast_cache = {}         # (name, version) -> cast Variable
    new_ops = []
    inserted = rewritten = skipped = 0
    bw_cache = {}

    def bump(op):
        # written_names, not output_arg_names: an undeclared sub-block
        # write (a while body updating an outer f32 var) must invalidate
        # the cast_cache entry for that name
        for n in written_names(program, op, cache=bw_cache):
            version[n] = version.get(n, 0) + 1

    for op in block.ops:
        if op.type not in AMP_SLOTS:
            new_ops.append(op)
            bump(op)
            continue
        slots = AMP_SLOTS[op.type]
        targets = []
        in_specs, specs_ok = {}, True
        for slot, vs in op.inputs.items():
            row = []
            for j, v in enumerate(vs):
                s = lowering.spec_of(v)
                if s is None:
                    specs_ok = False
                row.append(s)
                if (v.dtype == 'float32'
                        and (slots is None or slot in slots)):
                    targets.append((slot, j, v))
            in_specs[slot] = row
        if not targets:
            new_ops.append(op)
            bump(op)
            continue
        outs = None
        if specs_ok:
            for slot, j, v in targets:
                in_specs[slot][j] = _bf16_spec(in_specs[slot][j])
            try:
                outs = lowering.abstract_eval(op, in_specs)
            except Exception:   # noqa: BLE001 - the op stays in f32
                outs = None
        if outs is None:
            # the rewrite's dtypes cannot be proved: leave the op in f32
            # (more precise than runtime AMP; within the tolerance)
            skipped += 1
            new_ops.append(op)
            bump(op)
            continue
        seq = op.attrs.get(OP_SEQ_ATTR, 0)
        orig_out_names = list(op.output_arg_names)
        for slot, j, v in targets:
            ck = (v.name, version.get(v.name, 0))
            cv = cast_cache.get(ck)
            if cv is None:
                cv = block.create_var(
                    name='%s@amp.v%d.bf16' % (v.name, ck[1]),
                    shape=list(v.shape) if v.shape is not None else None,
                    dtype='bfloat16', lod_level=v.lod_level)
                new_ops.append(_cast_op(block, v, cv, 'bfloat16', seq))
                cast_cache[ck] = cv
                inserted += 1
            op.inputs[slot][j] = cv
        new_ops.append(op)
        # bf16 outputs where f32 was declared: route through a bf16 temp
        # and cast back, so downstream dtypes are the declared ones
        for slot, vs in op.outputs.items():
            vals = outs.get(slot) if hasattr(outs, 'get') else None
            if vals is None:
                continue
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for j, (var, val) in enumerate(zip(vs, vals)):
                if val is None:
                    continue
                spec = lowering.data_of(val)
                if spec.dtype == torch.bfloat16 and var.dtype == 'float32':
                    ov = block.create_var(
                        name=var.name + '@amp.out.bf16',
                        shape=(list(var.shape) if var.shape is not None
                               else None),
                        dtype='bfloat16', lod_level=var.lod_level)
                    ov.op = op
                    op.outputs[slot][j] = ov
                    new_ops.append(_cast_op(block, ov, var, 'float32',
                                            seq))
                    inserted += 1
        for n in orig_out_names:
            version[n] = version.get(n, 0) + 1
        rewritten += 1

    if rewritten or inserted:
        block.ops = new_ops
        program._bump_version()
        _C_CASTS.inc(inserted)
        _C_REWRITTEN.inc(rewritten)
    # the rewritten program must NOT also cast at run time: amp becomes a
    # property of the IR, and _amp_ir turns ctx.amp off even under the
    # global amp_guard (StepArtifact)
    program._amp = False
    program._amp_ir = True
    report.note('amp', ops_rewritten=rewritten, casts_inserted=inserted,
                ops_skipped=skipped)
    return rewritten
