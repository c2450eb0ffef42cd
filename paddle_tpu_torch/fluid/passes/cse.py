"""Common subexpression elimination over the top-level block.

Parity: the JAX package's fluid/passes/cse.py. Two ops compute the same
value when they have the same type, the same attrs (modulo positional
metadata: op_seq / op_role / op_device / op_namescope), and their inputs
refer to the same VALUES, not just the same names: the block is not SSA,
so each name carries a version bumped at every write, and the key uses
(name, version) pairs resolved through the alias map of merges already
made (chains of duplicates collapse in one walk).

A duplicate is merged only when:
  * the op is pure (passes.is_pure: a plain rule that draws nothing from
    the generator; two dropouts are never "the same computation");
  * every output name is written exactly once program-wide;
  * no output is a feed, a fetch target, a persistable, or a name some
    op's attr refers to by string (autodiff's loss / param / grad names,
    the control-flow rules' slot names).

A merged op is removed and every later read of its outputs (sub-blocks
included) is redirected to the kept op's outputs.
"""
from ... import obs
from . import OP_SEQ_ATTR, is_pure

__all__ = ['run']

_C_MERGED = obs.counter('passes.cse.ops_merged')

_KEY_SKIP_ATTRS = frozenset([OP_SEQ_ATTR, 'op_role', 'op_device',
                             'op_namescope'])


def _freeze(v):
    if isinstance(v, dict):
        return ('d',) + tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return ('l',) + tuple(_freeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return ('s',) + tuple(sorted(_freeze(x) for x in v))
    return v


def run(program, report, feeds=None, fetches=None):
    """Merge duplicate pure ops in place. Returns ops merged."""
    from . import write_counts as _write_counts
    from . import written_names as _written_names
    block = program.global_block()
    var_names = {v.name for v in program.list_vars()}
    persistables = {v.name for v in program.list_vars() if v.persistable}
    protected = set(fetches or ()) | set(feeds or ())
    write_counts = _write_counts(program)

    # every attr string (and string inside an attr list or dict) naming a
    # program variable is protected: over-protection costs a missed
    # merge, never a dangling name
    def _collect(v):
        if isinstance(v, str):
            if v in var_names:
                protected.add(v)
        elif isinstance(v, dict):
            for x in v.values():
                _collect(x)
        elif isinstance(v, (list, tuple, set, frozenset)):
            for x in v:
                _collect(x)

    for blk in program.blocks:
        for op in blk.ops:
            for v in op.attrs.values():
                _collect(v)

    version = {}   # name -> write version at the walk's current position
    alias = {}     # merged name -> surviving name

    def resolve(n):
        while n in alias:
            n = alias[n]
        return n

    seen = {}      # value key -> op
    merged_ops = set()
    merged = 0
    bw_cache = {}  # _block_writes memo for the version bumps below
    for op in block.ops:
        out_names = op.output_arg_names
        mergeable = (
            is_pure(op) and out_names
            and all(write_counts.get(n, 0) == 1 for n in out_names)
            and not any(n in persistables or n in protected
                        for n in out_names))
        if mergeable:
            key = (op.type,
                   _freeze({k: v for k, v in op.attrs.items()
                            if k not in _KEY_SKIP_ATTRS}),
                   tuple(sorted(
                       (slot, tuple((resolve(v.name),
                                     version.get(resolve(v.name), 0))
                                    for v in vs))
                       for slot, vs in op.inputs.items())))
            kept = seen.get(key)
            if kept is not None:
                ok = set(op.outputs) == set(kept.outputs) and all(
                    len(kept.outputs.get(slot, [])) == len(vs)
                    for slot, vs in op.outputs.items())
                if ok:
                    for slot, vs in op.outputs.items():
                        for dup_v, kept_v in zip(vs, kept.outputs[slot]):
                            alias[dup_v.name] = kept_v.name
                    merged_ops.add(id(op))
                    merged += 1
                    continue
            else:
                seen[key] = op
        # bump undeclared sub-block writes too: a while body updating an
        # outer name the while op never lists still changes what later
        # reads see
        for n in _written_names(program, op, cache=bw_cache):
            version[n] = version.get(n, 0) + 1

    if not merged:
        report.note('cse', ops_merged=0)
        return 0

    block.ops = [op for op in block.ops if id(op) not in merged_ops]
    # redirect every read of a merged name (all blocks: sub-block bodies
    # read outer names) to the surviving producer's variable
    for blk in program.blocks:
        for op in blk.ops:
            for slot, vs in op.inputs.items():
                new_vs = [block.vars.get(resolve(v.name))
                          or blk._var_recursive(resolve(v.name))
                          if resolve(v.name) != v.name else v for v in vs]
                if any(a is not b for a, b in zip(new_vs, vs)):
                    op.inputs[slot] = new_vs
    program._bump_version()
    _C_MERGED.inc(merged)
    report.note('cse', ops_merged=merged)
    return merged
