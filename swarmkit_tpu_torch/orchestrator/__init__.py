from .autoscaler import Supervisor as AutoscaleSupervisor
from .enforcers import ConstraintEnforcer, VolumeEnforcer
from .global_ import Orchestrator as GlobalOrchestrator
from .jobs import Orchestrator as JobsOrchestrator
from .replicated import Orchestrator as ReplicatedOrchestrator
from .restart import Supervisor as RestartSupervisor
from .taskreaper import TaskReaper
from .update import Supervisor as UpdateSupervisor

__all__ = [
    "AutoscaleSupervisor", "ConstraintEnforcer", "GlobalOrchestrator",
    "JobsOrchestrator", "ReplicatedOrchestrator", "RestartSupervisor",
    "TaskReaper", "UpdateSupervisor", "VolumeEnforcer",
]
