from .allocator import Allocator, PortAllocator
from .controlapi import ControlAPI
from .csi import CSIPlugin, InMemoryCSIPlugin, Manager as CSIManager
from .dispatcher import (
    AssignmentsMessage, AssignmentStream, DefaultConfig, Dispatcher,
)
from .keymanager import KeyManager
from .logbroker import LogBroker, LogMessage, LogSelector
from .manager import Manager
from .metrics import Collector
from .resourceapi import ResourceAPI
from .watchapi import WatchRequest, WatchServer

__all__ = ["Allocator", "AssignmentsMessage", "AssignmentStream",
           "CSIManager", "CSIPlugin", "Collector", "ControlAPI",
           "InMemoryCSIPlugin", "DefaultConfig", "Dispatcher",
           "KeyManager", "LogBroker", "LogMessage", "LogSelector",
           "Manager", "PortAllocator", "ResourceAPI", "WatchRequest", "WatchServer"]
