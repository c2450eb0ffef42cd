"""Memory-optimization transpiler.

Parity: reference transpiler/memory_optimization_transpiler.py, which
reused var buffers by liveness, and the JAX package's shim, which flags
the program so the executor rematerialises the forward under
jax.checkpoint. A captured CUDA graph has no counterpart of that yet:
its activations live in the graph's pool for the executor's life. So
both calls raise, naming the ROADMAP.md Queue A item that holds the
work, "Analysis and tooling". Dead-op pruning is PADDLE_TPU_OPT /
`Program.optimize()` (fluid.passes.dce).
"""

__all__ = ['memory_optimize', 'release_memory']

_MSG = ('%s: rematerialisation of the forward has no counterpart on a '
        'captured CUDA graph in the PyTorch port yet (ROADMAP.md Queue A, '
        '"Analysis and tooling"); for dead-op pruning use PADDLE_TPU_OPT '
        'or Program.optimize()')


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0):
    raise NotImplementedError(_MSG % 'memory_optimize')


def release_memory(input_program, skip_opt_set=None):
    raise NotImplementedError(_MSG % 'release_memory')
