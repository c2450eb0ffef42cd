"""Host-side utilities of the port: retry/backoff primitives
(utils.retry), the schedule reader.fault_tolerant re-opens its source on.
The JAX package's sharded checkpoints (utils.checkpoint) wait for the
parallel slice (ROADMAP.md Queue A, "Parallel")."""
from . import retry  # noqa: F401
