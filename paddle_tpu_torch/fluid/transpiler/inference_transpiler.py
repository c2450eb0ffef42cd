"""Inference transpiler: a deprecated shim over fluid.passes.

Parity: reference transpiler/inference_transpiler.py and the JAX
package's shim: it folds batch_norm into the preceding conv for
inference. The graph walk is `fluid.passes.fold.fold_batch_norm`; this
class keeps the reference API and delegates. The rest of what the
reference transpilers did ahead of execution (dead-op pruning, constant
folding, CSE) is PADDLE_TPU_OPT / `Program.optimize()`.
"""
import warnings

__all__ = ['InferenceTranspiler']


class InferenceTranspiler(object):
    def transpile(self, program, place=None, scope=None):
        """Fold batch_norm into an immediately preceding conv2d whose
        output it reads, rescaling the conv weights in `scope` (default:
        the global scope). Mutates program in place and returns it."""
        warnings.warn(
            'InferenceTranspiler is deprecated: the conv+BN fold lives in '
            'fluid.passes.fold.fold_batch_norm, and the general '
            'ahead-of-execution optimizations in PADDLE_TPU_OPT / '
            'Program.optimize().', DeprecationWarning, stacklevel=2)
        from ..executor import global_scope
        from ..passes.fold import fold_batch_norm
        if scope is None:
            scope = global_scope()
        fold_batch_norm(program, scope)
        return program
