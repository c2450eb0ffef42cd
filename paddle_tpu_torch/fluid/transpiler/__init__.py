"""Program transpilers.

Parity: reference python/paddle/fluid/transpiler/ and the JAX package's
fluid/transpiler: the distribute transpiler (a dp mesh with ZeRO, no
parameter servers) and its deprecated pserver dispatchers, the inference
and memory-optimization shims. The pipeline, sequence-parallel and
tensor-parallel transpilers wait in ROADMAP.md Queue A, "Parallel".
"""
from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)
from .inference_transpiler import InferenceTranspiler
from .memory_optimization_transpiler import memory_optimize, release_memory
from .ps_dispatcher import HashName, RoundRobin

__all__ = ['DistributeTranspiler', 'DistributeTranspilerConfig',
           'InferenceTranspiler', 'memory_optimize', 'release_memory',
           'HashName', 'RoundRobin']
