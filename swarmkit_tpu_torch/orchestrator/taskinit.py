"""Startup task-consistency pass: fix orphans and resume interrupted
delayed starts left behind by the previous leader.

Reference: manager/orchestrator/taskinit/init.go.
"""

from __future__ import annotations

import logging
from typing import Dict, List

from ..models.objects import Service, Task
from ..models.types import TaskState, now
from ..state.store import Batch, MemoryStore, ReadTx
from . import common
from .restart import Supervisor as RestartSupervisor

log = logging.getLogger("taskinit")


def check_tasks(store: MemoryStore, read_tx: ReadTx, init_handler,
                restarts: RestartSupervisor) -> None:
    """Fix tasks in the store before an orchestrator runs.

    ``init_handler`` provides: is_related_service(service) -> bool,
    fix_task(batch, task), slot_tuple(task) -> SlotTuple
    (reference: init.go:19 InitHandler).
    """
    instances: Dict[common.SlotTuple, List[Task]] = {}

    def cb(batch: Batch) -> None:
        for t in read_tx.find(Task):
            if not t.service_id:
                continue
            service = read_tx.get(Service, t.service_id)
            if service is None:
                # service was deleted; clean up the task
                def delete(tx, tid=t.id):
                    try:
                        tx.delete(Task, tid)
                    except Exception:
                        pass
                batch.update(delete)
                continue
            if not init_handler.is_related_service(service):
                continue

            tuple_ = init_handler.slot_tuple(t)
            instances.setdefault(tuple_, []).append(t)

            init_handler.fix_task(batch, t)

            # desired state READY is transient: the previous leader may not
            # have started it — retry the delayed start here
            if (t.desired_state != TaskState.READY
                    or t.status.state > TaskState.COMPLETE):
                continue
            restart_delay = common.DEFAULT_RESTART_DELAY
            if t.spec.restart is not None:
                restart_delay = t.spec.restart.delay
            if restart_delay:
                timestamp = t.status.applied_at or t.status.timestamp
                if timestamp:
                    remaining = (timestamp + restart_delay) - now()
                    restart_delay = min(remaining, restart_delay)
                if restart_delay > 0:
                    restarts.delay_start(None, t.id, restart_delay, True)
                    continue

            def start(tx, tid=t.id):
                restarts.start_now_tx(tx, tid)
            batch.update(start)

    store.batch(cb)

    # reconstruct restart history from retained task rows
    for tuple_, instance in instances.items():
        max_version = max((t.spec_version.index for t in instance
                           if t.spec_version is not None), default=0)
        up_to_date = [t for t in instance
                      if t.spec_version is not None
                      and t.spec_version.index == max_version]
        up_to_date.sort(key=lambda t: t.meta.created_at or 0.0)
        for t in up_to_date[1:]:
            restarts.record_restart_history(tuple_, t)
