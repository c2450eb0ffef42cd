"""Host-side utilities of the port: retry/backoff primitives
(utils.retry), the schedule reader.fault_tolerant re-opens its source on,
and the refcounted LRU (utils.lru) that the paged decode's prefix cache
and the streaming vocab share. The JAX package's sharded checkpoints
(utils.checkpoint) wait for the parallel slice (ROADMAP.md Queue A,
"Parallel")."""
from . import lru  # noqa: F401
from . import retry  # noqa: F401
