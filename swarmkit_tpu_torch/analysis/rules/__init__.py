"""Rule modules register themselves with the checker registry on import."""

from . import backpressure, determinism, device, fencing, layering, locking, metrics  # noqa: F401
