"""fluid.analysis — static analysis of the Fluid IR, ahead of execution.

Parity: the JAX package's fluid/analysis, reduced to what the pass
pipeline (fluid.passes) builds on: the structured `Finding` shape
(findings.py) and the dataflow / def-use pass (dataflow.py), whose
`live_mask` is the liveness dead-op elimination prunes by and whose
`run_pass` is the optimizer's def-use self-check. `executor_write_set`
is the memory plan's write set (passes/memplan.py).

Not ported yet (ROADMAP.md Queue A, "Analysis and tooling"): `analyze`,
the PADDLE_TPU_VERIFY gate and `Program.verify`, the shape, donation,
concurrency, sharding, cost-model and collective passes, and
tools/program_lint.py.
"""
from . import dataflow  # noqa: F401
from . import findings  # noqa: F401
from .dataflow import live_mask, op_reads, op_writes, run_pass, \
    sub_block_indices  # noqa: F401
from .findings import (Finding, ProgramVerifyError, SEV_ERROR, SEV_WARNING,
                       sort_findings)  # noqa: F401
from ..passes.memplan import executor_write_set  # noqa: F401

__all__ = ['Finding', 'ProgramVerifyError', 'SEV_ERROR', 'SEV_WARNING',
           'sort_findings', 'live_mask', 'op_reads', 'op_writes',
           'run_pass', 'sub_block_indices', 'executor_write_set']
