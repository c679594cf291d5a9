"""Fixture: the corrected twin — grammar-clean metric call sites."""

from swarmkit_tpu_torch.utils.metrics import registry


def record(route, bucket):
    registry.counter("swarm_scheduler_ticks")
    registry.counter(f'swarm_planner_groups{{mode="b",route="{route}"}}')
    registry.gauge(f'swarm_planner_compiles{{bucket="{bucket}"}}', 1.0)
    registry.timer("swarm_store_lock_hold_seconds")


def record_bounded(task, node, svc, tenant):
    # the bounded twins of the per-entity shapes: aggregate over
    # entities, label by operator-facing domains only
    registry.counter("swarm_task_restarts")
    registry.gauge('swarm_plane_occupancy{plane="dispatcher"}', 1.0)
    registry.counter(f'swarm_dispatcher_acks{{service="{svc.id}"}}')
    registry.gauge(f'swarm_tenant_usage{{tenant="{tenant}"}}', 1.0)
