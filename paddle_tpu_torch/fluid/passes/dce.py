"""Dead-op elimination: the dataflow pass's liveness as a pruning
transform.

Parity: the JAX package's fluid/passes/dce.py. `analysis.live_mask` (an
op is live when its outputs transitively reach a fetch or a persistable
write, sub-block persistable writes included) decides what to drop. The
executor caches the optimized clone per fetch set, so one run's fetch
list is exactly the right evidence: another fetch list gets its own
clone with its own liveness.

Beyond liveness, the transform keeps:
  * effectful ops (print) and ops with no rule: removing an op the step
    would have rejected turns a loud failure into a quiet success;
  * every op whose rule draws from the executor's generator
    (passes.uses_rng). The port's random rules draw one after another
    from one torch.Generator, registered with each captured graph, so
    dropping a dead dropout would move every later op's mask; the JAX
    package drops it and keeps the others' streams by their `op_seq`
    stamp (ROADMAP.md Queue C). The kept op's producers stay live too.
"""
from ... import obs
from .. import lowering
from ..analysis.dataflow import live_mask
from . import uses_rng

__all__ = ['run']

_C_REMOVED = obs.counter('passes.dce.ops_removed')

# ops whose execution is the point, whatever dataflow says
_KEEP = frozenset(['print'])


def _must_keep(op):
    if op.type in _KEEP:
        return True
    if op.type == 'autodiff':
        # the liveness walk itself decides autodiff (live iff a grad
        # feeds a live consumer); never force-keep it here
        return False
    if uses_rng(op):
        return True
    return not (lowering.has_rule(op.type)
                or op.type in lowering._BLOCK_RULES)


def run(program, report, fetches):
    """Drop dead top-level ops from `program` (in place: `program` is
    optimize()'s private clone). Returns the number removed."""
    block = program.global_block()
    # _must_keep rides INSIDE the liveness walk (not as a post-filter): a
    # kept op's producers must stay live too, or it would read a name
    # nothing defines
    live = live_mask(program, block, set(fetches), keep=_must_keep)
    keep = [op for op, alive in zip(block.ops, live) if alive]
    dropped = len(block.ops) - len(keep)
    if dropped:
        block.ops = keep
        program._bump_version()
        _C_REMOVED.inc(dropped)
    report.note('dce', ops_removed=dropped)
    return dropped
