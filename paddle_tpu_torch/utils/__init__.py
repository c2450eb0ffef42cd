"""Host-side utilities of the port: the native host library's build and
bindings (utils.native: the recordio scanner and the batched image
transform, C++ built at first use), retry/backoff primitives
(utils.retry), the schedule reader.fault_tolerant re-opens its source on,
the refcounted LRU (utils.lru) that the paged decode's prefix cache and
the streaming vocab share, and the seeded fault-injection harness
(utils.faults) the robustness drills run through. The JAX package's
sharded checkpoints (utils.checkpoint) wait for the parallel slice
(ROADMAP.md Queue A, "Parallel")."""
from . import faults  # noqa: F401
from . import lru  # noqa: F401
from . import retry  # noqa: F401
