"""The port's CSI controller and the agent's volumes, on the CPU.

- The port's copies of the reference's ``tests/test_csi.py``: the volume
  queue's backoff, and the CSI controller manager creating, publishing,
  unpublishing and deleting a volume against ``InMemoryCSIPlugin``,
  retrying a failed create.
- The reference's two end-to-end CSI cases of ``tests/test_controlapi.py``
  on the port's ``Manager`` (host path) and ``Agent``: a volume used by a
  task is published on its node, drained and unpublished; a
  ``ProcessExecutor`` task sees the volume staged on its node and the
  node unstages it after the task goes.  The reference drives them
  through its CLI, which the port does not carry yet; here each step is
  the control API call that CLI command makes.

Every wait polls with a bound, as the reference's do.
"""

import time

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch.manager import (  # noqa: E402
    CSIManager, InMemoryCSIPlugin,
)
from swarmkit_tpu_torch.models import (  # noqa: E402
    Annotations, ContainerSpec, ReplicatedService, ServiceMode, TaskSpec,
    Volume,
)
from swarmkit_tpu_torch.models.specs import (  # noqa: E402
    ServiceSpec, VolumeSpec,
)
from swarmkit_tpu_torch.models.types import (  # noqa: E402
    Driver, Mount, MountType, VolumeAccessMode, VolumeAccessScope,
    VolumeAvailability, VolumePublishStatus, VolumeSharing,
)
from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY  # noqa: E402
from swarmkit_tpu_torch.state import MemoryStore  # noqa: E402
from swarmkit_tpu_torch.utils import new_id  # noqa: E402
from swarmkit_tpu_torch.utils.volumequeue import VolumeQueue  # noqa: E402

from test_torch_dispatcher import (  # noqa: E402,F401  (the fixture)
    make_ready_node, poll, singletons_left_as_found,
)

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")


def create_volume(api, name):
    """``volume create NAME --driver inmem`` as the reference's CLI makes
    it: single-node scope, no sharing, no group."""
    vol = api.create_volume(VolumeSpec(
        annotations=Annotations(name=name), group="",
        driver=Driver(name="inmem"),
        access_mode=VolumeAccessMode(
            scope=VolumeAccessScope.SINGLE_NODE,
            sharing=VolumeSharing.NONE)))
    return vol.id


# ----------------------------------------------- tests/test_csi.py's cases


def make_volume(name, driver="inmem"):
    return Volume(id=new_id(),
                  spec=VolumeSpec(annotations=Annotations(name=name),
                                  driver=Driver(name=driver)))


def test_volumequeue_backoff_ordering():
    q = VolumeQueue()
    q.enqueue("a")
    assert q.wait(timeout=1) == "a"
    # fresh work stays immediate
    t0 = time.monotonic()
    q.enqueue("a")
    assert q.wait(timeout=1) == "a"
    assert time.monotonic() - t0 < 0.09
    # failures back off exponentially
    t0 = time.monotonic()
    q.enqueue("a", retry=True)
    assert q.wait(timeout=2) == "a"
    assert time.monotonic() - t0 >= 0.09
    t0 = time.monotonic()
    q.enqueue("a", retry=True)    # second failure: doubled delay
    assert q.wait(timeout=2) == "a"
    assert time.monotonic() - t0 >= 0.19
    q.forget("a")
    q.enqueue("a", retry=True)    # reset: back to base delay
    t0 = time.monotonic()
    assert q.wait(timeout=2) == "a"
    assert time.monotonic() - t0 < 0.19
    q.close()
    assert q.wait(timeout=0.1) is None


def test_csi_create_publish_unpublish_delete():
    store = MemoryStore()
    plugin = InMemoryCSIPlugin()
    mgr = CSIManager(store, plugins={"inmem": plugin})
    mgr.start()
    try:
        vol = make_volume("data")
        store.update(lambda tx: tx.create(vol))

        # created against the plugin
        poll(lambda: (store.view(lambda tx: tx.get(Volume, vol.id))
                      .volume_info is not None), msg="volume created")
        info = store.view(lambda tx: tx.get(Volume, vol.id)).volume_info
        assert info.volume_id in plugin.volumes

        # scheduler adds a pending publish (what commit_one does)
        def add_publish(tx):
            cur = tx.get(Volume, vol.id).copy()
            cur.publish_status.append(VolumePublishStatus(
                node_id="node1",
                state=VolumePublishStatus.State.PENDING_PUBLISH))
            tx.update(cur)
        store.update(add_publish)
        poll(lambda: all(
            ps.state == VolumePublishStatus.State.PUBLISHED
            for ps in store.view(
                lambda tx: tx.get(Volume, vol.id)).publish_status),
            msg="pending publish should become PUBLISHED")
        assert "node1" in plugin.published[info.volume_id]
        got = store.view(lambda tx: tx.get(Volume, vol.id))
        assert got.publish_status[0].publish_context["device"] \
            == f"/dev/{info.volume_id}"

        # unpublish then delete
        def mark_unpublish(tx):
            cur = tx.get(Volume, vol.id).copy()
            cur.publish_status[0].state = \
                VolumePublishStatus.State.PENDING_UNPUBLISH
            cur.pending_delete = True
            tx.update(cur)
        store.update(mark_unpublish)
        poll(lambda: store.view(lambda tx: tx.get(Volume, vol.id)) is None,
             msg="unpublished pending-delete volume should be removed")
        assert info.volume_id not in plugin.volumes
    finally:
        mgr.stop()


def test_csi_retries_with_backoff_on_failure():
    store = MemoryStore()
    plugin = InMemoryCSIPlugin()
    plugin.fail_next = "create"
    mgr = CSIManager(store, plugins={"inmem": plugin})
    mgr.start()
    try:
        vol = make_volume("flaky")
        store.update(lambda tx: tx.create(vol))
        # first attempt fails; the retry (with backoff) succeeds
        poll(lambda: (store.view(lambda tx: tx.get(Volume, vol.id))
                      .volume_info is not None), timeout=10,
             msg="creation should succeed on retry")
    finally:
        mgr.stop()


# ------------------- tests/test_controlapi.py's CSI cases, through the API

@requires_crypto
def test_csi_volume_lifecycle_e2e_through_the_api():
    """Volume create -> schedule a task using it -> publish -> drain ->
    unpublish (the volume API, the CSI manager and the volumes filter
    together), each step the control API call the reference's CLI makes
    (the port has no CLI yet)."""
    import time

    from swarmkit_tpu_torch.agent import Agent
    from swarmkit_tpu_torch.agent.testutils import TestExecutor
    from swarmkit_tpu_torch.manager import Manager
    from swarmkit_tpu_torch.manager.dispatcher import Config_
    from swarmkit_tpu_torch.models import Task, TaskState
    from swarmkit_tpu_torch.models.types import VolumePublishStatus

    m = Manager(dispatcher_config=Config_(
        heartbeat_period=0.3, heartbeat_epsilon=0.02,
        process_updates_interval=0.02, assignment_batching_wait=0.02),
        use_device_scheduler=False)
    m.run()
    api2 = m.control_api
    n = make_ready_node("csi-n1")
    m.store.update(lambda tx, n=n: tx.create(n))
    agent = Agent(n.id, TestExecutor(hostname="csi-n1"), m.dispatcher)
    agent.start()
    try:
        vid = create_volume(api2, "data1")
        # csi manager creates it plugin-side
        poll(lambda: api2.get_volume(vid).volume_info is not None
             and api2.get_volume(vid).volume_info.volume_id,
             timeout=10, msg="csi manager should create the volume")

        dbsvc = api2.create_service(ServiceSpec(
            annotations=Annotations(name="dbsvc"),
            task=TaskSpec(container=ContainerSpec(
                image="db", mounts=[Mount(type=MountType.CSI,
                                          source="data1",
                                          target="/data")])),
            mode=ServiceMode.REPLICATED,
            replicated=ReplicatedService(replicas=1)))

        def task_running_with_volume():
            ts = [t for t in api2.list_tasks()
                  if t.service_annotations.name == "dbsvc"
                  and t.desired_state == TaskState.RUNNING]
            return (ts and ts[0].status.state == TaskState.RUNNING
                    and any(va.id == vid for va in ts[0].volumes))
        poll(task_running_with_volume, timeout=20,
             msg="task should run with the volume attached")

        def published():
            v = api2.get_volume(vid)
            return any(p.node_id == n.id and p.state ==
                       VolumePublishStatus.State.PUBLISHED
                       for p in v.publish_status)
        poll(published, timeout=10,
             msg="csi manager should controller-publish on the node")

        # drain: the volume enforcer evicts the task, the csi manager
        # unpublishes once unused
        v = api2.get_volume(vid)
        vspec = v.spec.copy()
        vspec.availability = int(VolumeAvailability.DRAIN)
        api2.update_volume(v.id, v.meta.version.index, vspec)

        def unpublished():
            v = api2.get_volume(vid)
            return not v.publish_status
        poll(unpublished, timeout=20,
             msg="drained volume should unpublish after eviction")

        # and now removable without force
        api2.remove_service(dbsvc.id)
        api2.remove_volume(vid, force=False)
        poll(lambda: not [v for v in api2.list_volumes()
                          if v.spec.annotations.name == "data1"],
             timeout=10, msg="pending-delete volume should be deleted")
    finally:
        agent.stop()
        m.stop()


@requires_crypto
def test_node_side_csi_staging_with_process_executor(tmp_path):
    """Worker-side CSI (reference: agent/csi/volumes.go): the agent
    stages/publishes the volume to a local path before the process task
    starts, exposes it via env, and unstages after shutdown (the volume
    made through the control API, as the reference's CLI makes it)."""
    import os

    from swarmkit_tpu_torch.agent import Agent
    from swarmkit_tpu_torch.agent.procexec import ProcessExecutor
    from swarmkit_tpu_torch.manager import Manager
    from swarmkit_tpu_torch.manager.dispatcher import Config_
    from swarmkit_tpu_torch.models import TaskState
    from swarmkit_tpu_torch.models.specs import (
        ContainerSpec, ServiceSpec,
    )
    from swarmkit_tpu_torch.models import (
        ReplicatedService, ServiceMode, TaskSpec,
    )
    from swarmkit_tpu_torch.models.types import Mount, MountType

    m = Manager(dispatcher_config=Config_(
        heartbeat_period=0.3, heartbeat_epsilon=0.02,
        process_updates_interval=0.02, assignment_batching_wait=0.02),
        use_device_scheduler=False)
    m.run()
    api2 = m.control_api
    n = make_ready_node("csi-p1")
    m.store.update(lambda tx, n=n: tx.create(n))
    agent = Agent(n.id, ProcessExecutor(
        hostname="csi-p1", log_dir=str(tmp_path / "logs")), m.dispatcher,
        task_db_path=str(tmp_path / "node" / "tasks.db"))
    agent.start()
    try:
        vid = create_volume(api2, "pdata")
        poll(lambda: api2.get_volume(vid).volume_info is not None
             and api2.get_volume(vid).volume_info.volume_id, timeout=10)

        marker = tmp_path / "proof"
        svc = api2.create_service(ServiceSpec(
            annotations=Annotations(name="vol-writer"),
            task=TaskSpec(container=ContainerSpec(
                image="process",
                command=["sh", "-c",
                         f'echo "$SWARM_VOLUME_DATA" > {marker}; '
                         'touch "$SWARM_VOLUME_DATA/wrote"; sleep 30'],
                mounts=[Mount(type=MountType.CSI, source="pdata",
                              target="/data")])),
            mode=ServiceMode.REPLICATED,
            replicated=ReplicatedService(replicas=1)))

        def running():
            ts = [t for t in api2.list_tasks(service_id=svc.id)
                  if t.desired_state == TaskState.RUNNING]
            return ts and ts[0].status.state == TaskState.RUNNING
        poll(running, timeout=20, msg="volume task should run")

        poll(lambda: marker.exists() and marker.read_text().strip(),
             timeout=10, msg="task should see the volume path env")
        vol_path = marker.read_text().strip()
        assert os.path.isdir(vol_path), vol_path
        assert os.path.exists(os.path.join(vol_path, "wrote"))
        assert agent.volumes.ready(vid)

        # removal: task goes away, node unstages, path is gone
        api2.remove_service(svc.id)
        poll(lambda: not agent.volumes.ready(vid), timeout=20,
             msg="volume should unstage after the task is removed")
        poll(lambda: not os.path.exists(vol_path), timeout=10,
             msg="published path should be cleaned up")
        poll(lambda: not api2.get_volume(vid).publish_status, timeout=20,
             msg="controller-unpublish should complete")
    finally:
        agent.stop()
        m.stop()
