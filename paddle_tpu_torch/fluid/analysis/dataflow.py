"""Pass 1 — dataflow / def-use over Program blocks.

Parity: the JAX package's fluid/analysis/dataflow.py, copied as it is (it
is pure Python over the Program IR, which the port shares key for key).

Checks:
  * DanglingInput    — an op reads a name nothing defines at its position
                       (not a feed, not an initialized persistable, not an
                       earlier op's output);
  * WriteToFeed      — an op output overwrites a feed variable;
  * UnreachableFetch — a fetch target nothing in the program defines;
  * DeadOp           — (only when the fetch set is known) an op whose
                       outputs reach no fetch and no persistable write —
                       warning severity (the step would still run it);
  * UseBeforeWrite   — a persistable read before any write that the given
                       startup program never initializes (under
                       run_bundle's scan carry this is the
                       "persistable output has no value in the scope yet"
                       rejection, surfaced at build time).

The env model mirrors the executor exactly: at step entry env holds the
feed dict plus every scope-initialized persistable; ops then bind outputs
in order (lowering.run_op raises KeyError on a missing input — this pass
is that error, ahead of time and with provenance).

Sub-blocks (while/ifelse/switch/static_rnn/dynamic_rnn bodies) are walked
with an ORDER-INSENSITIVE definition set: a loop body may legally read a
carry written later in the body (the value arrives from the previous
iteration), so inside a sub-block only names written nowhere at all count
as dangling.
"""
from ..framework import Parameter
from .findings import (Finding, SEV_ERROR, SEV_WARNING, DANGLING_INPUT,
                       WRITE_TO_FEED, DEAD_OP, UNREACHABLE_FETCH,
                       USE_BEFORE_WRITE)

__all__ = ['run_pass', 'sub_block_indices', 'op_reads', 'op_writes',
           'live_mask']


def sub_block_indices(op, program=None):
    """Block indices an op executes as its body/bodies (while, ifelse,
    switch, static_rnn, dynamic_rnn — anything carrying the standard
    sub_block/sub_blocks attrs). With `program` given, out-of-range
    indices are dropped — a corrupted artifact (program_lint feeds
    untrusted __model__.json) must produce findings, not IndexErrors."""
    idxs = []
    sb = op.attrs.get('sub_block')
    if isinstance(sb, int):
        idxs.append(sb)
    sbs = op.attrs.get('sub_blocks')
    if isinstance(sbs, (list, tuple)):
        # non-int entries (corrupted artifact) are dropped, not cast:
        # analyze() must survive adversarial attrs, never TypeError
        idxs.extend(b for b in sbs if isinstance(b, int))
    if program is not None:
        idxs = [b for b in idxs if 0 < b < program.num_blocks]
    return idxs


def _block_writes(program, block, seen=None, cache=None):
    """Every name written anywhere in `block` or its nested sub-blocks.
    `cache` (block idx -> frozen result, one dict per analyze() run —
    blocks are immutable during an analysis) is consulted/populated only
    for top-level entries: a mid-cycle partial result must not stick."""
    top = seen is None
    if top:
        if cache is not None and block.idx in cache:
            return cache[block.idx]
        seen = set()
    if block.idx in seen:
        return set()
    seen.add(block.idx)
    writes = set()
    for op in block.ops:
        writes.update(op.output_arg_names)
        for bi in sub_block_indices(op, program):
            writes |= _block_writes(program, program.block(bi), seen)
    if top and cache is not None:
        cache[block.idx] = writes
    return writes


def op_reads(program, op, _seen=None, cache=None):
    """Names an op consumes, including names its sub-blocks read that the
    sub-blocks themselves never define (i.e. reads of OUTER values). The
    `_seen` block-index set guards against cyclic sub_block attrs in
    hand-built or corrupted programs; `cache` memoizes _block_writes
    across the many per-op calls one analysis makes."""
    if _seen is None:
        _seen = {op.block.idx}
    reads = set(op.input_arg_names)
    if op.type == 'while':
        # loop carries must hold a value BEFORE the loop (the While rule
        # raises otherwise); they are outputs, but also reads
        reads.update(op.output_arg_names)
    for bi in sub_block_indices(op, program):
        if bi in _seen:
            continue
        _seen.add(bi)
        sub = program.block(bi)
        local = _block_writes(program, sub, cache=cache)
        for sop in sub.ops:
            reads.update(n for n in op_reads(program, sop, _seen, cache)
                         if n not in local)
    return reads


def op_writes(op):
    return set(op.output_arg_names)


def _walk_block(program, block, defined, feed_names, findings,
                order_insensitive=False, seen_blocks=None, cache=None):
    """Walk a block's ops against the running `defined` set (mutated in
    place), recursing into sub-blocks. Returns nothing; findings append.
    `seen_blocks` guards the recursion against cyclic sub_block attrs."""
    if seen_blocks is None:
        seen_blocks = set()
    seen_blocks = seen_blocks | {block.idx}
    local_pool = (_block_writes(program, block, cache=cache)
                  if order_insensitive else None)
    for i, op in enumerate(block.ops):
        if op.type == 'autodiff':
            # defines every @GRAD var from the traced forward; its only
            # true read is the loss
            loss = op.attrs.get('loss_name')
            if loss and loss not in defined:
                findings.append(Finding.for_op(
                    DANGLING_INPUT, SEV_ERROR,
                    'autodiff differentiates loss %r which nothing '
                    'defines' % loss, op, var_names=(loss,)))
            defined.update(op.output_arg_names)
            defined.update(op.attrs.get('grad_names', ()))
            continue
        for slot, vs in op.inputs.items():
            for v in vs:
                n = v.name
                if n in defined:
                    continue
                if order_insensitive and n in local_pool:
                    continue
                findings.append(Finding.for_op(
                    DANGLING_INPUT, SEV_ERROR,
                    'input %r (slot %r) is read but never defined: not a '
                    'feed, not an initialized persistable, and no earlier '
                    'op writes it' % (n, slot), op, var_names=(n,)))
                defined.add(n)   # report each dangling name once
        if op.type == 'while':
            missing = [n for n in op.output_arg_names if n not in defined]
            for n in missing:
                findings.append(Finding.for_op(
                    DANGLING_INPUT, SEV_ERROR,
                    'While carry %r has no value before the loop — write '
                    'it (fill_constant / array_write) first so its shape '
                    'is known' % n, op, var_names=(n,)))
                defined.add(n)
        for bi in sub_block_indices(op, program):
            if bi in seen_blocks:
                continue
            sub = program.block(bi)
            sub_defined = set(defined)
            _walk_block(program, sub, sub_defined, feed_names, findings,
                        order_insensitive=True, seen_blocks=seen_blocks,
                        cache=cache)
        for n in op_writes(op):
            # feed_names is the caller's EXACT feed set when given (an
            # unfed data var is an ordinary intermediate), else every
            # declared data var (standalone mode)
            if n in feed_names:
                findings.append(Finding.for_op(
                    WRITE_TO_FEED, SEV_ERROR,
                    'op overwrites feed variable %r — feeds are step '
                    'inputs, not scratch space' % n, op, var_names=(n,)))
            defined.add(n)


def live_mask(program, block, fetch_names, cache=None, keep=None):
    """Backward liveness over `block`: live[i] is True when op i's outputs
    transitively reach a fetch or a persistable write — including
    persistable writes that happen only inside the op's sub-blocks (a
    While body updating a counter is live even when its carries are not
    fetched). Shared by the DeadOp finding below and the dead-op
    ELIMINATION transform (fluid.passes.dce), so the verifier's warning
    and the optimizer's pruning can never disagree.

    keep — optional predicate forcing ops live regardless of dataflow
    (DCE passes its keep-effectful rule here, so a retained `print` op's
    PRODUCERS stay live too; the backward walk propagates its reads like
    any other live op's)."""
    if cache is None:
        cache = {}
    persistables = {v.name for v in program.list_vars() if v.persistable}
    needed = set(fetch_names)
    live = [False] * len(block.ops)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        writes = op_writes(op)
        writes_persist = any(
            getattr(v, 'persistable', False)
            for vs in op.outputs.values() for v in vs)
        if not writes_persist:
            writes_persist = any(
                _block_writes(program, program.block(bi), cache=cache)
                & persistables
                for bi in sub_block_indices(op, program))
        if op.type == 'autodiff':
            # live iff any of its grads feed a live consumer
            if writes & needed:
                live[i] = True
                needed.add(op.attrs.get('loss_name', ''))
                needed.update(op.input_arg_names)
            continue
        forced = keep is not None and keep(op)
        if forced or writes_persist or (writes & needed):
            live[i] = True
            needed.update(op_reads(program, op, cache=cache))
    return live


def _liveness(program, block, fetch_names, findings, cache=None):
    """DeadOp findings from live_mask: dead ops are warnings (the step
    still runs them; passes.dce drops them)."""
    live = live_mask(program, block, fetch_names, cache=cache)
    for i, op in enumerate(block.ops):
        if not live[i]:
            findings.append(Finding.for_op(
                DEAD_OP, SEV_WARNING,
                'outputs %r reach no fetch and write no persistable — the '
                'op is dead for this fetch list'
                % sorted(op_writes(op)), op))


def run_pass(program, feeds=None, fetches=None, initialized=None,
             startup=None, bundle=False, dead_ops=True):
    """Run the dataflow pass. See analysis.analyze for the contract of
    feeds/fetches/initialized/startup/bundle. dead_ops=False skips the
    DeadOp liveness check (the executor wiring: one run's fetch subset is
    not evidence an op is dead — another call may fetch it)."""
    findings = []
    block = program.global_block()
    cache = {}   # per-analysis _block_writes memo (blocks are immutable)
    persistables = {v.name for v in program.list_vars() if v.persistable}

    if initialized is not None:
        defined = set(initialized)
    else:
        # standalone mode: assume every declared data var may be fed and
        # every persistable was initialized (startup ran)
        defined = {v.name for v in program.list_vars()
                   if getattr(v, 'is_data', False)}
        defined |= persistables
    feed_names = set(feeds) if feeds is not None else {
        v.name for v in program.list_vars() if getattr(v, 'is_data', False)}
    defined |= feed_names

    # UseBeforeWrite: a persistable read before any program write, that the
    # startup program never initializes. Needs the startup program to judge
    # — without it "uninitialized" is unknowable and the check stays quiet.
    if startup is not None:
        started = _block_writes(startup, startup.global_block())
        started |= {v.name for v in startup.list_vars()
                    if isinstance(v, Parameter)}
        written = set()
        flagged = set()
        for op in block.ops:
            if op.type == 'autodiff':
                written.update(op.attrs.get('grad_names', ()))
                continue
            for n in op_reads(program, op, cache=cache):
                if (n in persistables and n not in written
                        and n not in started and n not in feed_names
                        and n not in flagged):
                    flagged.add(n)
                    findings.append(Finding.for_op(
                        USE_BEFORE_WRITE, SEV_ERROR,
                        'persistable %r is read before any write and the '
                        'startup program never initializes it' % n, op,
                        var_names=(n,)))
            written.update(op_writes(op))

    # run_bundle's scan carry needs every written persistable to already
    # hold a scope value (executor.run_bundle raises otherwise); with scope
    # knowledge (initialized) this surfaces at verify time instead
    if bundle and initialized is not None:
        written_persist = {n for op in block.ops
                           for n in op_writes(op) if n in persistables}
        gap = sorted(written_persist - set(initialized))
        if gap:
            findings.append(Finding(
                USE_BEFORE_WRITE, SEV_ERROR,
                'persistable output(s) %r have no value in the scope, so '
                'they cannot thread through run_bundle\'s scan carry — run '
                'the startup program (or one unbundled step) first' % gap,
                var_names=gap))

    _walk_block(program, block, defined, feed_names, findings, cache=cache)

    if fetches is not None:
        produced = set(defined)
        for n in fetches:
            if n not in produced:
                findings.append(Finding(
                    UNREACHABLE_FETCH, SEV_ERROR,
                    'fetch target %r: no op produces it, it is not fed, '
                    'and no initialized persistable carries it' % n,
                    var_names=(n,)))
        if dead_ops:
            _liveness(program, block, set(fetches), findings, cache=cache)
    return findings
