"""The manager's components that the port carries so far.

Only the task allocator is here (``allocator.py`` with the network driver
registry it reads, ``netdriver.py``): it moves orchestrator-made tasks from
NEW to PENDING, so the scheduler sees them.  The reference package's
``Manager``, dispatcher, control API and the other components are not
ported yet; this package exports only what is.
"""

from .allocator import Allocator, PortAllocator

__all__ = ["Allocator", "PortAllocator"]
