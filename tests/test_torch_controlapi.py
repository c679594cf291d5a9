"""The port's control API, on the CPU.

- The port's copies of the reference's ``tests/test_controlapi.py``
  cases that need no ``Manager``, CLI, agent or wire (those modules are
  not ported yet): validated CRUD of services, nodes, secrets, configs,
  networks, volumes, extensions and resources with the reference's
  error messages, the network allocator's addresses, and the cluster's
  redacted key material.  The join-token rotation runs on an API bound
  to a ``RootCA`` (gated on ``HAVE_CRYPTOGRAPHY``, as the reference
  gates its CA cases).
- A differential: one call sequence through both packages'
  ``ControlAPI``, each over its own store with the same id counter and
  clock, returns the same objects and raises the same errors.
"""

import importlib
import itertools
import time

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch.manager import ControlAPI  # noqa: E402
from swarmkit_tpu_torch.manager.controlapi import (  # noqa: E402
    AlreadyExists, FailedPrecondition, InvalidArgument, NotFound,
)
from swarmkit_tpu_torch.models import (  # noqa: E402
    Annotations, EndpointSpec, Node, NodeAvailability, NodeDescription,
    NodeState, NodeStatus, PortConfig, PublishMode, ReplicatedService,
    Resources, ResourceRequirements, ServiceMode, TaskSpec, UpdateConfig,
)
from swarmkit_tpu_torch.models.specs import (  # noqa: E402
    ContainerSpec, NodeSpec, SecretSpec, ServiceSpec,
)
from swarmkit_tpu_torch.models.types import (  # noqa: E402
    NodeRole, SecretReference,
)
from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY  # noqa: E402
from swarmkit_tpu_torch.state import MemoryStore  # noqa: E402
from swarmkit_tpu_torch.utils import new_id  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
T0 = 1_700_000_000.0

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")


def poll(cond, timeout=8.0, interval=0.05, msg="condition not met"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        result = cond()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(msg)


def make_node(name, availability=NodeAvailability.ACTIVE,
              state=NodeState.READY, labels=None):
    return Node(
        id=new_id(),
        spec=NodeSpec(annotations=Annotations(name=name, labels=labels or {}),
                      availability=availability),
        status=NodeStatus(state=state),
        description=NodeDescription(hostname=name),
    )


def spec(name="web", replicas=1, image="nginx", **kw):
    return ServiceSpec(
        annotations=Annotations(name=name),
        task=TaskSpec(container=ContainerSpec(image=image)),
        mode=ServiceMode.REPLICATED,
        replicated=ReplicatedService(replicas=replicas),
        **kw,
    )


@pytest.fixture
def api():
    return ControlAPI(MemoryStore())


def test_create_service_validates_name(api):
    with pytest.raises(InvalidArgument, match="meta: name must be provided"):
        api.create_service(spec(name=""))
    with pytest.raises(InvalidArgument,
                       match="name must be valid as a DNS name component"):
        api.create_service(spec(name="not valid!"))
    with pytest.raises(InvalidArgument,
                       match="name must be 63 characters or fewer"):
        api.create_service(spec(name="x" * 64))


def test_create_service_validates_runtime_and_resources(api):
    s = spec()
    s.task.container = None
    with pytest.raises(InvalidArgument, match="TaskSpec: missing runtime"):
        api.create_service(s)

    s = spec()
    s.task.container.image = ""
    with pytest.raises(InvalidArgument,
                       match="image reference must be provided"):
        api.create_service(s)

    s = spec()
    s.task.resources = ResourceRequirements(
        reservations=Resources(memory_bytes=1024))
    with pytest.raises(InvalidArgument, match="Must be at least 4MiB"):
        api.create_service(s)


def test_create_service_name_conflict(api):
    api.create_service(spec(name="web"))
    with pytest.raises(AlreadyExists):
        api.create_service(spec(name="web"))


def test_create_service_missing_secret(api):
    s = spec()
    s.task.container.secrets = [
        SecretReference(secret_id="nope", secret_name="missing",
                        target="cert")]
    with pytest.raises(InvalidArgument, match="secret not found: missing"):
        api.create_service(s)


def test_create_service_with_existing_secret(api):
    secret = api.create_secret(SecretSpec(
        annotations=Annotations(name="tls-cert"), data=b"shh"))
    s = spec()
    s.task.container.secrets = [
        SecretReference(secret_id=secret.id, secret_name="tls-cert",
                        target="cert")]
    created = api.create_service(s)
    assert created.spec.task.container.secrets[0].secret_id == secret.id


def test_update_service_rules(api):
    created = api.create_service(spec(name="web", replicas=2))
    new_spec = spec(name="web", replicas=5)
    updated = api.update_service(created.id, created.meta.version.index,
                                 new_spec)
    assert updated.spec.replicated.replicas == 5
    assert updated.previous_spec is not None
    assert updated.spec_version.index > created.spec_version.index

    with pytest.raises(InvalidArgument,
                       match="renaming services is not supported"):
        api.update_service(updated.id, updated.meta.version.index,
                           spec(name="web2", replicas=5))

    bad = spec(name="web", replicas=5)
    bad.mode = ServiceMode.GLOBAL
    bad.replicated = None
    with pytest.raises(InvalidArgument,
                       match="service mode change is not allowed"):
        api.update_service(updated.id, updated.meta.version.index, bad)

    # stale version -> FailedPrecondition
    with pytest.raises(FailedPrecondition):
        api.update_service(updated.id, updated.meta.version.index - 1,
                           spec(name="web", replicas=7))


def test_ingress_port_conflict(api):
    s1 = spec(name="a")
    s1.endpoint = EndpointSpec(ports=[PortConfig(
        target_port=80, published_port=8080,
        publish_mode=PublishMode.INGRESS)])
    api.create_service(s1)
    s2 = spec(name="b")
    s2.endpoint = EndpointSpec(ports=[PortConfig(
        target_port=80, published_port=8080,
        publish_mode=PublishMode.INGRESS)])
    with pytest.raises(InvalidArgument,
                       match="already in use by service 'a'"):
        api.create_service(s2)


def test_remove_service(api):
    created = api.create_service(spec())
    api.remove_service(created.id)
    with pytest.raises(NotFound):
        api.get_service(created.id)
    with pytest.raises(NotFound):
        api.remove_service(created.id)


def test_node_remove_rules(api):
    node = make_node("n1")
    api.store.update(lambda tx: tx.create(node))
    with pytest.raises(FailedPrecondition,
                       match="is not down and can't be removed"):
        api.remove_node(node.id)
    api.remove_node(node.id, force=True)
    with pytest.raises(NotFound):
        api.get_node(node.id)


def test_demote_last_manager_fails(api):
    node = make_node("m1")
    node.spec.desired_role = NodeRole.MANAGER
    api.store.update(lambda tx: tx.create(node))
    demote = NodeSpec(annotations=Annotations(name="m1"),
                      desired_role=NodeRole.WORKER)
    with pytest.raises(FailedPrecondition,
                       match="attempting to demote the last manager"):
        api.update_node(node.id, node.meta.version.index, demote)


def test_secret_lifecycle(api):
    with pytest.raises(InvalidArgument):
        api.create_secret(SecretSpec(annotations=Annotations(name="s"),
                                     data=b""))
    secret = api.create_secret(SecretSpec(
        annotations=Annotations(name="s"), data=b"data"))
    with pytest.raises(AlreadyExists):
        api.create_secret(SecretSpec(annotations=Annotations(name="s"),
                                     data=b"x"))

    # the payload never leaves the manager — list AND get strip it
    # (reference: secret.go:44,143); the stored object keeps it
    listed = api.list_secrets()
    assert listed[0].spec.data == b""
    assert api.get_secret(secret.id).spec.data == b""
    from swarmkit_tpu_torch.models import Secret as _Secret
    assert api.store.view(
        lambda tx: tx.get(_Secret, secret.id)).spec.data == b"data"

    with pytest.raises(InvalidArgument,
                       match="only updates to Labels are allowed"):
        api.update_secret(secret.id, secret.meta.version.index,
                          SecretSpec(annotations=Annotations(name="s"),
                                     data=b"different"))
    updated = api.update_secret(
        secret.id, secret.meta.version.index,
        SecretSpec(annotations=Annotations(name="s",
                                           labels={"env": "prod"})))
    assert updated.spec.annotations.labels == {"env": "prod"}
    assert updated.spec.data == b""   # responses stay stripped
    assert api.store.view(
        lambda tx: tx.get(_Secret, secret.id)).spec.data == b"data"

    api.remove_secret(secret.id)
    with pytest.raises(NotFound):
        api.get_secret(secret.id)


def test_remove_secret_in_use(api):
    secret = api.create_secret(SecretSpec(
        annotations=Annotations(name="tls"), data=b"shh"))
    s = spec(name="web")
    s.task.container.secrets = [
        SecretReference(secret_id=secret.id, secret_name="tls",
                        target="cert")]
    svc = api.create_service(s)
    # materialize a task referencing the secret (orchestrator would)
    from swarmkit_tpu_torch.orchestrator.common import new_task
    t = new_task(None, api.store.view(
        lambda tx: tx.get(type(svc), svc.id)), 1, "")
    api.store.update(lambda tx: tx.create(t))
    with pytest.raises(InvalidArgument,
                       match="is in use by the following service: web"):
        api.remove_secret(secret.id)


def test_update_config_validation(api):
    s = spec()
    s.update = UpdateConfig(max_failure_ratio=1.5)
    with pytest.raises(InvalidArgument, match="maxfailureratio"):
        api.create_service(s)


def test_network_ipam_allocation():
    """Networks get subnets carved from the default pool; services on
    them get VIPs; tasks get per-network addresses (reference:
    manager/allocator network allocation)."""
    import time

    from swarmkit_tpu_torch.manager.allocator import Allocator
    from swarmkit_tpu_torch.models import (
        Annotations, Network, NetworkAttachmentConfig, Task, TaskState,
    )
    from swarmkit_tpu_torch.models.specs import NetworkSpec
    from swarmkit_tpu_torch.state import ByService

    store = MemoryStore()
    api = ControlAPI(store)
    alloc = Allocator(store)
    alloc.start()
    try:
        n1 = api.create_network(NetworkSpec(
            annotations=Annotations(name="backend")))
        n2 = api.create_network(NetworkSpec(
            annotations=Annotations(name="frontend")))
        poll(lambda: store.view(
            lambda tx: all(tx.get(Network, i).ipam is not None
                           for i in (n1.id, n2.id))),
            msg="subnets allocated")
        nets = store.view(lambda tx: [tx.get(Network, i)
                                      for i in (n1.id, n2.id)])
        subnets = [n.ipam.configs[0].subnet for n in nets]
        assert len(set(subnets)) == 2, "distinct subnets"
        assert all(s.endswith("/24") for s in subnets), subnets
        gws = [n.ipam.configs[0].gateway for n in nets]
        assert all(g.endswith(".1") for g in gws), gws

        # service attached to both networks: VIP per network
        svc_spec = spec("webnet", replicas=2)
        svc_spec.task.networks = [
            NetworkAttachmentConfig(target="backend"),
            NetworkAttachmentConfig(target=n2.id)]
        svc = api.create_service(svc_spec)
        poll(lambda: (api.get_service(svc.id).endpoint is not None
                      and len(api.get_service(svc.id)
                              .endpoint.virtual_ips) == 2),
             msg="VIPs on both networks")
        vips = api.get_service(svc.id).endpoint.virtual_ips
        assert {v.network_id for v in vips} == {n1.id, n2.id}
        assert all(v.addr for v in vips)

        # tasks carry per-network addresses, all distinct (created
        # directly: no orchestrator runs in this test)
        from swarmkit_tpu_torch.models.types import TaskStatus
        from swarmkit_tpu_torch.utils import new_id

        def mk(tx):
            for slot in (1, 2):
                tx.create(Task(
                    id=new_id(), service_id=svc.id, slot=slot,
                    spec=svc_spec.task.copy(),
                    status=TaskStatus(state=TaskState.NEW),
                    desired_state=TaskState.RUNNING))
        store.update(mk)

        def task_addrs():
            ts = store.view(lambda tx: tx.find(Task, ByService(svc.id)))
            if len(ts) < 2 or any(
                    t.status.state < TaskState.PENDING for t in ts):
                return None
            return [a for t in ts for att in t.networks
                    for a in att.addresses]
        addrs = poll(task_addrs, msg="task addresses allocated")
        assert len(addrs) == 4                     # 2 tasks x 2 networks
        assert len(set(addrs)) == 4, "addresses must be unique"
        vip_addrs = {v.addr for v in vips}
        assert not vip_addrs & set(addrs), "VIPs never reused for tasks"
    finally:
        alloc.stop()


def _vol_spec(name="vol1", driver="csi.example", group="", sharing=None,
              secrets=None):
    from swarmkit_tpu_torch.models.specs import VolumeSpec
    from swarmkit_tpu_torch.models.types import Driver, VolumeAccessMode

    return VolumeSpec(
        annotations=Annotations(name=name), group=group,
        driver=Driver(name=driver),
        access_mode=VolumeAccessMode(sharing=sharing or 0),
        secrets=dict(secrets or {}))


def test_volume_crud_lifecycle(api):
    from swarmkit_tpu_torch.models.types import VolumeAvailability

    with pytest.raises(InvalidArgument, match="driver must be specified"):
        api.create_volume(_vol_spec(driver=""))
    with pytest.raises(InvalidArgument, match="name must be provided"):
        api.create_volume(_vol_spec(name=""))

    v = api.create_volume(_vol_spec())
    assert api.get_volume(v.id).spec.annotations.name == "vol1"
    with pytest.raises(AlreadyExists):
        api.create_volume(_vol_spec())

    # only labels + availability are mutable
    spec2 = v.spec.copy()
    spec2.group = "changed"
    with pytest.raises(InvalidArgument, match="Group cannot be updated"):
        api.update_volume(v.id, v.meta.version.index, spec2)
    spec3 = v.spec.copy()
    spec3.annotations.labels["tier"] = "fast"
    spec3.availability = int(VolumeAvailability.DRAIN)
    updated = api.update_volume(v.id, v.meta.version.index, spec3)
    assert updated.spec.annotations.labels == {"tier": "fast"}
    assert updated.spec.availability == int(VolumeAvailability.DRAIN)

    assert [x.id for x in api.list_volumes()] == [v.id]
    api.remove_volume(v.id)           # unused -> marked pending delete
    assert api.get_volume(v.id).pending_delete
    api.remove_volume(v.id, force=True)
    with pytest.raises(NotFound):
        api.get_volume(v.id)


def test_volume_create_reports_all_missing_secrets(api):
    with pytest.raises(InvalidArgument, match="secrets not found"):
        api.create_volume(_vol_spec(secrets={"a": "sec-a", "b": "sec-b"}))


def test_volume_in_use_refuses_remove(api):
    from swarmkit_tpu_torch.models.objects import Volume
    from swarmkit_tpu_torch.models.types import VolumePublishStatus

    v = api.create_volume(_vol_spec())

    def publish(tx):
        cur = tx.get(Volume, v.id).copy()
        cur.publish_status.append(VolumePublishStatus(node_id="n1"))
        tx.update(cur)
    api.store.update(publish)
    with pytest.raises(FailedPrecondition, match="still in use"):
        api.remove_volume(v.id)


def test_extension_and_resource_lifecycle(api):
    with pytest.raises(InvalidArgument, match="name must be provided"):
        api.create_extension(Annotations(name=""))
    ext = api.create_extension(Annotations(name="widgets"),
                               "custom widget type")
    with pytest.raises(AlreadyExists):
        api.create_extension(Annotations(name="widgets"))

    with pytest.raises(InvalidArgument, match="not registered"):
        api.create_resource(Annotations(name="w1"), "gadgets")
    r = api.create_resource(Annotations(name="w1"), "widgets",
                            b"payload-1")
    assert api.get_resource(r.id).payload == b"payload-1"
    assert [x.id for x in api.list_resources(kind="widgets")] == [r.id]

    # extension removal is refused while resources of its kind exist
    with pytest.raises(InvalidArgument, match="in use by resources"):
        api.remove_extension(ext.id)

    # payload + labels mutable; renames rejected
    ann = r.annotations.copy()
    ann.name = "renamed"
    with pytest.raises(InvalidArgument, match="Name cannot be updated"):
        api.update_resource(r.id, r.meta.version.index, annotations=ann)
    r2 = api.update_resource(r.id, r.meta.version.index,
                             payload=b"payload-2")
    assert r2.payload == b"payload-2"

    api.remove_resource(r.id)
    api.remove_extension(ext.id)
    with pytest.raises(NotFound):
        api.get_extension(ext.id)


def test_cluster_responses_redact_key_material():
    """get/list/get_default cluster strip signing + unlock keys but keep
    join tokens, and a redacted inspect→update round trip preserves the
    stored signing CA material (reference: controlapi/cluster.go:252
    redactClusters)."""
    from swarmkit_tpu_torch.manager.controlapi import ControlAPI
    from swarmkit_tpu_torch.models import Cluster
    from swarmkit_tpu_torch.models.objects import RootCAState
    from swarmkit_tpu_torch.models.specs import ClusterSpec
    from swarmkit_tpu_torch.models.types import (
        Annotations, EncryptionKey, JoinTokens,
    )
    from swarmkit_tpu_torch.state import MemoryStore

    store = MemoryStore()
    spec = ClusterSpec(annotations=Annotations(name="default"))
    spec.ca_config.signing_ca_key = b"SIGNKEY"
    spec.ca_config.signing_ca_cert = b"SIGNCERT"
    store.update(lambda tx: tx.create(Cluster(
        id="c1", spec=spec,
        root_ca=RootCAState(
            ca_key=b"CAKEY", ca_cert=b"CACERT",
            rotation_ca_key=b"ROTKEY",
            join_tokens=JoinTokens(worker="SWMTKN-w", manager="SWMTKN-m")),
        unlock_keys=[EncryptionKey(subsystem="manager", key=b"UNLOCK")],
        network_bootstrap_keys=[
            EncryptionKey(subsystem="networking", key=b"GOSSIP")])))
    api = ControlAPI(store)

    for c in (api.get_cluster("c1"), api.get_default_cluster(),
              *api.list_clusters()):
        assert c.spec.ca_config.signing_ca_key == b""
        assert c.spec.ca_config.signing_ca_cert == b""
        assert c.root_ca.ca_key == b""
        assert c.root_ca.rotation_ca_key == b""
        assert c.unlock_keys == []
        assert c.network_bootstrap_keys == []
        # public material survives redaction
        assert c.root_ca.ca_cert == b"CACERT"
        assert c.root_ca.join_tokens.worker == "SWMTKN-w"

    # in-process raw reads still see the key material (autolock path)
    assert api._default_cluster_raw().unlock_keys[0].key == b"UNLOCK"

    # redacted round trip: update with a blanked spec keeps signing keys
    c = api.get_default_cluster()
    new_spec = c.spec.copy()
    new_spec.dispatcher.heartbeat_period = 7.0
    api.update_cluster(c.id, c.meta.version.index, new_spec)
    stored = api._default_cluster_raw()
    assert stored.spec.dispatcher.heartbeat_period == 7.0
    assert stored.spec.ca_config.signing_ca_key == b"SIGNKEY"
    assert stored.spec.ca_config.signing_ca_cert == b"SIGNCERT"


@requires_crypto
def test_rotate_join_token_on_a_ca_bound_api():
    """The port's counterpart of the reference's
    ``test_rotate_join_token_via_api``, on an API bound to a ``RootCA``
    the way the reference's ``Manager`` binds it (``root_ca`` set, the
    default cluster holding the CA's trust root and join tokens): the
    rotated worker token replaces the stored one, and the CA refuses the
    old token."""
    from swarmkit_tpu_torch.manager.controlapi import APIError
    from swarmkit_tpu_torch.models import Cluster, ClusterSpec
    from swarmkit_tpu_torch.models.objects import RootCAState
    from swarmkit_tpu_torch.models.types import JoinTokens
    from swarmkit_tpu_torch.security import RootCA

    ca = RootCA()
    store = MemoryStore()
    store.update(lambda tx: tx.create(Cluster(
        id=new_id(),
        spec=ClusterSpec(annotations=Annotations(name="default")),
        root_ca=RootCAState(
            ca_key=ca.key, ca_cert=ca.cert_pem,
            join_tokens=JoinTokens(
                worker=ca.join_token(NodeRole.WORKER),
                manager=ca.join_token(NodeRole.MANAGER))))))
    api = ControlAPI(store)
    with pytest.raises(APIError, match="requires the manager CA"):
        api.rotate_join_token(NodeRole.WORKER)
    api.root_ca = ca
    old = api.get_default_cluster().root_ca.join_tokens.worker
    new = api.rotate_join_token(NodeRole.WORKER)
    assert new != old
    assert ca.join_token(NodeRole.WORKER) == new
    assert ca.role_for_token(new) == NodeRole.WORKER
    assert api.get_default_cluster().root_ca.join_tokens.worker == new
    with pytest.raises(Exception):
        ca.role_for_token(old)


# ------------------------------------------------- the same calls, twice

class Pkg:
    def __init__(self, name):
        def mod(path):
            return importlib.import_module(f"{name}.{path}")

        self.name = name
        self.api = mod("manager.controlapi")
        self.m = mod("models")
        self.specs = mod("models.specs")
        self.types = mod("models.types")
        self.identity = mod("utils.identity")
        self.serde = mod("state.serde")
        self.state = mod("state")
        self.metrics = mod("utils.metrics")


PKGS = {name: Pkg(name) for name in (REF, PORT)}


def api_script(p):
    """One call sequence through ``p``'s ``ControlAPI``: every call's
    result as plain data, or its error's class and message."""
    m, sp, ty = p.m, p.specs, p.types
    store = p.state.MemoryStore()
    nodes = [m.Node(
        id=f"node-{i}",
        spec=sp.NodeSpec(annotations=m.Annotations(name=f"n{i}")),
        status=m.NodeStatus(state=m.NodeState.READY),
        description=m.NodeDescription(hostname=f"n{i}"))
        for i in range(3)]

    def setup(tx):
        tx.create(m.Cluster(id="cluster-0", spec=sp.ClusterSpec(
            annotations=m.Annotations(name="default"))))
        for n in nodes:
            tx.create(n)

    store.update(setup)
    api = p.api.ControlAPI(store)

    def svc(name, replicas=1, **kw):
        return sp.ServiceSpec(
            annotations=m.Annotations(name=name),
            task=m.TaskSpec(container=sp.ContainerSpec(image="nginx")),
            mode=m.ServiceMode.REPLICATED,
            replicated=m.ReplicatedService(replicas=replicas), **kw)

    def port(published):
        return m.EndpointSpec(ports=[m.PortConfig(
            target_port=80, published_port=published,
            publish_mode=m.PublishMode.INGRESS)])

    def small_reservation():
        s = svc("tiny")
        s.task.resources = m.ResourceRequirements(
            reservations=m.Resources(memory_bytes=1024))
        return s

    def bad_update_config():
        s = svc("cfg")
        s.update = m.UpdateConfig(max_failure_ratio=1.5)
        return s

    def missing_secret():
        s = svc("sec")
        s.task.container.secrets = [ty.SecretReference(
            secret_id="nope", secret_name="missing", target="cert")]
        return s

    def global_web():
        s = svc("web", 5)
        s.mode, s.replicated = m.ServiceMode.GLOBAL, None
        return s

    def version(kind, oid):
        return store.view(lambda tx: tx.get(getattr(m, kind), oid)
                          ).meta.version.index

    ids = {}
    steps = [
        ("web", lambda: api.create_service(svc("web", 2))),
        (None, lambda: api.create_service(svc(""))),
        (None, lambda: api.create_service(svc("not valid!"))),
        (None, lambda: api.create_service(svc("web"))),
        (None, lambda: api.create_service(small_reservation())),
        (None, lambda: api.create_service(bad_update_config())),
        (None, lambda: api.create_service(missing_secret())),
        ("db", lambda: api.create_service(svc("db", endpoint=port(8080)))),
        (None, lambda: api.create_service(svc("db2",
                                              endpoint=port(8080)))),
        (None, lambda: api.update_service(
            ids["web"], version("Service", ids["web"]), svc("web", 5))),
        (None, lambda: api.update_service(
            ids["web"], version("Service", ids["web"]) - 1,
            svc("web", 7))),
        (None, lambda: api.update_service(
            ids["web"], version("Service", ids["web"]), svc("web2", 5))),
        (None, lambda: api.update_service(
            ids["web"], version("Service", ids["web"]), global_web())),
        (None, lambda: api.update_service("nope", 1, svc("web"))),
        (None, lambda: api.list_services("d")),
        (None, lambda: api.list_services()),
        (None, lambda: api.update_node(
            "node-0", version("Node", "node-0"), sp.NodeSpec(
                annotations=m.Annotations(name="n0"),
                availability=m.NodeAvailability.DRAIN))),
        (None, lambda: api.update_node(
            "node-0", version("Node", "node-0") - 1,
            sp.NodeSpec(annotations=m.Annotations(name="n0")))),
        (None, lambda: api.remove_node("node-1")),
        (None, lambda: api.remove_node("node-1", force=True)),
        (None, lambda: api.get_node("node-1")),
        (None, lambda: api.list_nodes()),
        ("secret", lambda: api.create_secret(sp.SecretSpec(
            annotations=m.Annotations(name="tls"), data=b"shh"))),
        (None, lambda: api.create_secret(sp.SecretSpec(
            annotations=m.Annotations(name="tls"), data=b"x"))),
        (None, lambda: api.list_secrets()),
        ("config", lambda: api.create_config(sp.ConfigSpec(
            annotations=m.Annotations(name="conf"), data=b"k=v"))),
        (None, lambda: api.list_configs()),
        ("net", lambda: api.create_network(sp.NetworkSpec(
            annotations=m.Annotations(name="backend")))),
        (None, lambda: api.list_networks()),
        (None, lambda: api.remove_network(ids["net"])),
        (None, lambda: api.remove_service(ids["db"])),
        (None, lambda: api.get_service(ids["db"])),
        (None, lambda: api.remove_service(ids["db"])),
        (None, lambda: api.get_default_cluster()),
        (None, lambda: api.list_tasks(service_id=ids["web"])),
        (None, lambda: api.get_service(ids["web"])),
    ]
    out = []
    for name, call in steps:
        try:
            got = call()
        except Exception as exc:
            out.append(("error", type(exc).__name__, str(exc)))
            continue
        if name is not None:
            ids[name] = got.id
        if isinstance(got, list):
            got = [p.serde.to_dict(o) for o in got]
        elif got is not None:
            got = p.serde.to_dict(got)
        out.append(("ok", got))
    rows = store.view(lambda tx: sorted(
        (type(o).__name__, o.id, p.serde.to_dict(o))
        for kind in ("Cluster", "Node", "Service", "Secret", "Config",
                     "Network")
        for o in tx.find(getattr(m, kind))))
    return out, rows


def test_control_api_calls_match_reference():
    results = {}
    for name, p in PKGS.items():
        n = itertools.count()
        p.types.set_time_source(lambda: T0)
        p.identity.set_id_source(lambda n=n: f"id{next(n):08d}")
        try:
            results[name] = api_script(p)
        finally:
            p.types.set_time_source(None)
            p.identity.set_id_source(None)
    (ref_out, ref_rows), (port_out, port_rows) = results[REF], results[PORT]
    for i, (a, b) in enumerate(zip(port_out, ref_out)):
        assert a == b, f"call {i}: port {a!r} != reference {b!r}"
    assert len(port_out) == len(ref_out)
    assert port_rows == ref_rows
    errors = [r for r in port_out if r[0] == "error"]
    assert len(errors) >= 12, errors
