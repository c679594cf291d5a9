"""The manager's components that the port carries so far.

The task allocator (``allocator.py`` with the network driver registry it
reads, ``netdriver.py``) moves orchestrator-made tasks from NEW to PENDING,
so the scheduler sees them.  The API surfaces every raft member serves come
next to it: the users' write and read surface (``controlapi.py``), the
agents' resource calls (``resourceapi.py``), resumable watches
(``watchapi.py``), the log broker, the key and role managers and the
metrics collector.  The reference package's ``manager.py`` (``Manager``),
``dispatcher.py``, ``csi.py``, ``deallocator.py`` and ``drivers.py`` are not
ported yet; this package exports only what is.
"""

from .allocator import Allocator, PortAllocator
from .controlapi import ControlAPI
from .keymanager import KeyManager
from .logbroker import LogBroker, LogMessage, LogSelector
from .metrics import Collector
from .resourceapi import ResourceAPI
from .watchapi import WatchRequest, WatchServer

__all__ = ["Allocator", "Collector", "ControlAPI", "KeyManager",
           "LogBroker", "LogMessage", "LogSelector", "PortAllocator",
           "ResourceAPI", "WatchRequest", "WatchServer"]
