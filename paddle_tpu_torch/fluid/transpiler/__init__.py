"""Program transpilers.

Parity: reference python/paddle/fluid/transpiler/ and the JAX package's
fluid/transpiler, reduced to the inference and memory-optimization
shims. The distribute, pipeline, sequence-parallel and tensor-parallel
transpilers and the parameter-server dispatchers wait in ROADMAP.md
Queue A, "Parallel".
"""
from .inference_transpiler import InferenceTranspiler
from .memory_optimization_transpiler import memory_optimize, release_memory

__all__ = ['InferenceTranspiler', 'memory_optimize', 'release_memory']
