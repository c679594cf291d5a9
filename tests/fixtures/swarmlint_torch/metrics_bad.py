"""Fixture: metric names violating the exposition grammar (must fire)."""

from swarmkit_tpu_torch.utils.metrics import registry


def record(route):
    registry.counter("swarm_Tick-Seconds")           # bad characters
    registry.counter('swarm_planner_groups{route="a",mode="b"}')  # unsorted
    registry.gauge(
        f'swarm_health{{check="{route}",check="{route}"}}', 1.0)  # duplicate
    registry.timer('swarm_store_lock{Holder="x"}')   # uppercase label key


def record_per_entity(task, node, session):
    # metric-cardinality shapes: one series per task/node/session id
    # grows with the cluster, not the code — must fire
    registry.counter(f'swarm_task_restarts{{task="{task.id}"}}')
    registry.gauge(f'swarm_node_load{{node_id="{node.id}"}}', 1.0)
    registry.counter(
        f'swarm_dispatcher_acks{{session="{session.id}"}}')
