"""Per-program memory plan: which persistables a step writes.

Parity: the JAX package's fluid/passes/memplan.py (MemoryPlan :35,
memory_plan :113) and the write set it is built from
(fluid/analysis/donation.py:29, executor_write_set). The port keeps its
own copy, reduced to what a captured step uses: the JAX plan's donation
vector and sharding trees have no counterpart here.

A step's persistables split in two:

  * written ("donated" in the JAX package's words): the persistables the
    top-level block writes. On the card they are the captured graph's
    static state, updated in place at the end of every replay, and the
    scope holds those same tensors;
  * read-only: everything else the step reads (weights of an inference
    step, frozen tables). A step never re-emits them, so the scope's
    tensors stay valid across a call and are only read.
"""

__all__ = ['MemoryPlan', 'memory_plan', 'executor_write_set']


def executor_write_set(program):
    """Persistable names the TOP-LEVEL block writes."""
    persistable = {v.name for v in program.list_vars() if v.persistable}
    return {n for op in program.global_block().ops
            for n in op.output_arg_names if n in persistable}


class MemoryPlan(object):
    """Written/read-only split of one Program's persistables."""

    __slots__ = ('write_set', 'donates')

    def __init__(self, write_set):
        self.write_set = frozenset(write_set)
        self.donates = bool(self.write_set)

    def donate_names(self, persist_in):
        """The initialized persistables the step writes."""
        return sorted(n for n in persist_in if n in self.write_set)

    def readonly_names(self, persist_in):
        """The persistables the step only reads."""
        return sorted(n for n in persist_in if n not in self.write_set)

    def split(self, persist):
        """(written, readonly) dicts from a full persist dict."""
        donated = {n: v for n, v in persist.items() if n in self.write_set}
        readonly = {n: v for n, v in persist.items()
                    if n not in self.write_set}
        return donated, readonly

    def persist_out(self):
        """Names the step writes back to the scope."""
        return sorted(self.write_set)

    def __repr__(self):
        return 'MemoryPlan(donates=%s, writes=%d)' % (
            self.donates, len(self.write_set))


def memory_plan(program):
    """The memory plan of `program`."""
    return MemoryPlan(executor_write_set(program))
