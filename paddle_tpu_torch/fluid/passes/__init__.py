"""Program passes of the port: the memory plan alone so far (the JAX
package's fluid/passes holds DCE, folding, CSE, AMP and quantization too;
ROADMAP.md Queue A, "The other IR passes, and int8")."""
from .memplan import MemoryPlan, memory_plan, executor_write_set

__all__ = ['MemoryPlan', 'memory_plan', 'executor_write_set']
