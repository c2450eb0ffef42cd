"""Constant folding: evaluate constant subgraphs at optimization time.

Parity: the JAX package's fluid/passes/fold.py (_eval_rule :61, run,
fold_batch_norm :163). Constant sources are `fill_constant` and
`assign_value` ops (no inputs, value fixed by attrs). Any op that is
FOLDABLE (passes.is_foldable: pure, no generator, no context) and whose
inputs are all constants is evaluated through ITS OWN rule, the function
the step runs, and replaced by an `assign_value` op carrying the result.
The constant producers left unconsumed are swept by DCE.

The rules run on torch tensors on the executor's device (`device`, passed
through Executor._prepare), so a folded transcendental is the value the
step computes there, bit for bit; the JAX package folds on its default
backend.

Budget: results larger than the level's element cap are not folded (the
folded values live in op attrs). `default` caps at 4096 elements,
`aggressive` at 262144.

Also here: `fold_batch_norm`, the conv+BN weight fold that
InferenceTranspiler delegates to (it rewrites SCOPE weights, not graph
constants).
"""
import numpy as np
import torch

from ... import obs
from .. import core, lowering
from ..framework import Operator
from . import is_foldable

__all__ = ['run', 'fold_batch_norm']

_C_FOLDED = obs.counter('passes.fold.ops_folded')

_CAPS = {'default': 4096, 'aggressive': 1 << 18}

# value-from-attrs constant producers (seed the lattice; no inputs)
_SOURCES = frozenset(['fill_constant', 'assign_value'])

# sources larger than this are never even materialized into the constant
# lattice: a startup program's vocab-sized zero accumulators must not cost
# the optimizer hundreds of MB it would throw away
_SOURCE_CAP = 1 << 20


def _source_size(op):
    shape = op.attrs.get('shape') or ()
    n = 1
    for d in shape:
        n *= max(int(d), 1) if isinstance(d, int) else 1
    return n


def _eval_rule(op, const_vals, device):
    """Run the op's rule on concrete constant inputs on `device`. Returns
    {slot: [tensor, ...]} or None when the result is unusable (a SeqValue,
    a missing output)."""
    ins = {slot: [const_vals[v.name] for v in vs]
           for slot, vs in op.inputs.items()}
    with torch.no_grad():
        outs = lowering.get_rule(op.type)(ins, op.attrs,
                                          lowering.Ctx(device))
    result = {}
    for slot, vs in op.outputs.items():
        vals = outs.get(slot) if hasattr(outs, 'get') else None
        if vals is None:
            return None
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        if len(vals) < len(vs):
            return None
        row = []
        for val in vals[:len(vs)]:
            if not isinstance(val, torch.Tensor):
                return None
            row.append(val)
        result[slot] = row
    return result


def _const_op(block, var, value, src_op):
    """An assign_value op binding `var` to the folded `value`, carrying
    the folded op's provenance and seq stamp. A bf16 value is stored as
    its float32 widening (exact) with dtype 'bfloat16'."""
    t = value.detach().cpu()
    dtype = core.convert_dtype(t.dtype)
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    attrs = {'values': t.numpy().tolist(), 'shape': list(t.shape),
             'dtype': dtype}
    for carry in ('op_seq', 'op_role'):
        if carry in src_op.attrs:
            attrs[carry] = src_op.attrs[carry]
    return Operator(block, type='assign_value', inputs={},
                    outputs={'Out': [var]}, attrs=attrs,
                    callsite=src_op.callsite)


def run(program, report, level='default', device=None):
    """Fold constant top-level subgraphs in place, evaluating on `device`
    (default: the CPU). Returns ops folded."""
    from . import write_counts as _write_counts
    device = torch.device('cpu') if device is None else torch.device(device)
    cap = _CAPS.get(level, _CAPS['default'])
    block = program.global_block()
    write_counts = _write_counts(program)

    const_vals = {}   # name -> concrete value (producers written once)
    folded = 0
    for i, op in enumerate(block.ops):
        out_names = op.output_arg_names
        ssa = all(write_counts.get(n, 0) == 1 for n in out_names)
        if (op.type in _SOURCES and ssa and not op.inputs
                and _source_size(op) <= _SOURCE_CAP):
            try:
                vals = _eval_rule(op, const_vals, device)
            except Exception:   # noqa: BLE001 - an unusable source
                vals = None
            if vals is not None:
                for slot, vs in op.outputs.items():
                    for v, val in zip(vs, vals[slot]):
                        const_vals[v.name] = val
            continue
        if (ssa and out_names and is_foldable(op) and op.inputs
                and all(v.name in const_vals
                        for vs in op.inputs.values() for v in vs)):
            try:
                vals = _eval_rule(op, const_vals, device)
            except Exception:   # noqa: BLE001 - left to the step
                vals = None
            if vals is not None and all(
                    v.numel() <= cap for row in vals.values() for v in row):
                # single-output ops fold to ONE assign_value; multi-output
                # ops would need one per output, rare enough to skip
                slots = [(s, vs) for s, vs in op.outputs.items() if vs]
                if len(slots) == 1 and len(slots[0][1]) == 1:
                    slot, var = slots[0][0], slots[0][1][0]
                    val = vals[slot][0]
                    block.ops[i] = _const_op(block, var, val, op)
                    const_vals[var.name] = val
                    folded += 1
                    continue
                # not replaced, but the VALUE is known: later consumers
                # can fold through it
                for slot, vs in op.outputs.items():
                    for v, val in zip(vs, vals[slot]):
                        const_vals[v.name] = val
            continue
        for n in out_names:
            const_vals.pop(n, None)   # overwritten: no longer constant
    if folded:
        program._bump_version()
        _C_FOLDED.inc(folded)
    report.note('fold', ops_folded=folded)
    return folded


def _host(t):
    return t.detach().to('cpu', torch.float32).numpy()


def fold_batch_norm(program, scope):
    """Fold `batch_norm` into an immediately preceding `conv2d` whose
    output it reads: the conv weights are rescaled in the SCOPE by the BN
    statistics and the BN op becomes a bias `elementwise_add`. As in the
    JAX package, only adjacency is checked, not that the conv output has
    no other consumer (ROADMAP.md Queue C). The arithmetic is the JAX
    function's, in numpy float32, so the folded weights are its bits.
    Returns the number of BN ops folded."""
    block = program.global_block()
    folded = 0
    i = 0
    while i < len(block.ops) - 1:
        op = block.ops[i]
        nxt = block.ops[i + 1]
        if op.type == 'conv2d' and nxt.type == 'batch_norm' and \
                nxt.inputs['X'][0].name == op.outputs['Output'][0].name:
            scale_v = scope._chain_get(nxt.inputs['Scale'][0].name)
            bias_v = scope._chain_get(nxt.inputs['Bias'][0].name)
            mean_v = scope._chain_get(nxt.inputs['Mean'][0].name)
            var_v = scope._chain_get(nxt.inputs['Variance'][0].name)
            w_name = op.inputs['Filter'][0].name
            w = scope._chain_get(w_name)
            if any(v is None for v in (scale_v, bias_v, mean_v, var_v, w)):
                i += 1
                continue
            eps = nxt.attrs.get('epsilon', 1e-5)
            scale, bias = _host(scale_v), _host(bias_v)
            mean, var = _host(mean_v), _host(var_v)
            inv = scale / np.sqrt(var + eps)
            scope._chain_set(w_name, torch.from_numpy(
                _host(w) * inv[:, None, None, None]).to(w.device))
            new_bias = bias - mean * inv
            bias_var = block.create_var(
                name=w_name + '.bnfold_bias', shape=list(new_bias.shape),
                dtype='float32', persistable=True)
            scope._chain_set(bias_var.name,
                             torch.from_numpy(new_bias).to(w.device))
            bn_out = nxt.outputs['Y'][0]
            # the channel axis follows the conv's layout
            ch_axis = (-1 if op.attrs.get('data_format', 'NCHW') == 'NHWC'
                       else 1)
            block.ops[i + 1] = Operator(
                block, type='elementwise_add',
                inputs={'X': op.outputs['Output'], 'Y': [bias_var]},
                outputs={'Out': [bn_out]}, attrs={'axis': ch_axis},
                callsite=nxt.callsite)
            program._bump_version()
            folded += 1
        i += 1
    return folded
