"""The port's ``template.py`` and ``rafttool.py`` on the CPU: the template
and rafttool cases of ``tests/test_template_storage.py`` (its task DB
cases are in ``test_torch_agent.py``), and the two packages' rafttools
reading each other's sealed state dirs.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import importlib
import json
import os

import pytest

from swarmkit_tpu_torch import template
from swarmkit_tpu_torch.models import Task, TaskSpec, TaskState, TaskStatus
from swarmkit_tpu_torch.models.specs import ContainerSpec
from swarmkit_tpu_torch.models.types import (
    Annotations, NodeDescription, Platform,
)
from swarmkit_tpu_torch.utils import new_id

from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY

from test_torch_dispatcher import (  # noqa: F401  (the fixture)
    poll, singletons_left_as_found,
)

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")


def make_task():
    return Task(
        id="task1", service_id="svc1", slot=3, node_id="nodeA",
        service_annotations=Annotations(name="web",
                                        labels={"env": "prod"}),
        spec=TaskSpec(container=ContainerSpec(
            image="nginx",
            env=["SERVICE={{.Service.Name}}", "SLOT={{.Task.Slot}}",
                 "HOST={{.Node.Hostname}}", "PLAIN=1"],
            hostname="{{.Service.Name}}-{{.Task.Slot}}",
            labels={"which": "{{index .Service.Labels \"env\"}}"})),
        status=TaskStatus(state=TaskState.ASSIGNED))


def test_template_container_spec_expansion():
    node = NodeDescription(hostname="host7",
                           platform=Platform(os="linux",
                                             architecture="amd64"))
    out = template.expand_container_spec(node, make_task())
    assert out.env == ["SERVICE=web", "SLOT=3", "HOST=host7", "PLAIN=1"]
    assert out.hostname == "web-3"
    assert out.labels == {"which": "prod"}
    assert template.task_name(make_task()) == "web.3.task1"


def test_template_payload_functions_and_errors():
    t = make_task()
    node = NodeDescription(hostname="host7")
    data = b'user={{env "SERVICE"}} secret={{secret "tls"}}'
    out = template.expand_secret_payload(
        data, node, t, secrets={"tls": b"sekrit"})
    assert out == b"user=web secret=sekrit"

    with pytest.raises(template.TemplateError,
                       match="secret not found: nope"):
        template.expand_secret_payload(b'{{secret "nope"}}', node, t)
    with pytest.raises(template.TemplateError,
                       match="cannot evaluate template expression"):
        template.expand_secret_payload(b"{{.Bogus.Path}}", node, t)
    # binary payloads pass through untouched
    blob = bytes(range(256))
    assert template.expand_secret_payload(blob, node, t) == blob


def test_rafttool_dumps(tmp_path):
    from swarmkit_tpu_torch import rafttool
    from swarmkit_tpu_torch.state import MemoryStore
    from swarmkit_tpu_torch.state.raft import (
        LocalNetwork, RaftLogger, RaftNode,
    )
    from swarmkit_tpu_torch.models import Node, NodeSpec

    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_dispatcher import poll

    state_dir = os.path.join(tmp_path, "m0")
    net = LocalNetwork()
    store = MemoryStore()
    rn = RaftNode("m0", ["m0"], store, RaftLogger(state_dir), net,
                  snapshot_interval=2)
    store._proposer = rn
    rn.start()
    try:
        poll(lambda: rn.is_leader, timeout=10)
        for name in ("a", "b", "c", "d"):
            store.update(lambda tx, name=name: tx.create(Node(
                id=new_id(),
                spec=NodeSpec(annotations=Annotations(name=name)))))
    finally:
        rn.stop()

    wal = rafttool.dump_wal(state_dir)
    assert any(r["type"] == "hardstate" for r in wal)
    snap = rafttool.dump_snapshot(state_dir)
    assert snap is not None and snap["objects"]["nodes"] >= 2
    objs = rafttool.dump_objects(state_dir, "nodes")
    assert all("id" in o for o in objs)


@requires_crypto
def test_rafttool_on_encrypted_swarmd_dir(tmp_path):
    """dump/decrypt/downgrade-key/renew-certs against a REAL swarmd
    manager state dir (encrypted WAL under the persisted CA key; autolock
    sealing) — reference: swarm-rafttool decrypt + downgrade-key +
    renewcert."""
    import tempfile

    from swarmkit_tpu_torch import rafttool
    from swarmkit_tpu_torch.cli import run_command
    from swarmkit_tpu_torch.swarmd import Swarmd

    from test_torch_dispatcher import make_replicated, poll

    state_dir = str(tmp_path)
    m = Swarmd(state_dir=state_dir, hostname="m0", manager=True,
               listen_remote_api=("127.0.0.1", 0),
               use_device_scheduler=False, device="cpu")
    m.start()
    api = m.manager.control_api
    svc = api.create_service(make_replicated("tooling", 1).spec)
    key = api.set_autolock(True)   # seal the state file
    import os as _os
    poll(lambda: open(_os.path.join(state_dir, "manager-state.json"),
                      "rb").read(5) == b"LOCK1",
         msg="state file re-seals under the new unlock key")
    m.stop()

    # dumps decrypt the WAL via the (sealed) persisted CA key
    snap_or_wal = rafttool.dump_wal(state_dir, key)
    assert any(r.get("type") == "entry" for r in snap_or_wal)
    # wrong key fails closed
    import pytest
    from swarmkit_tpu_torch.swarmd import ManagerLockedError
    with pytest.raises(ManagerLockedError):
        rafttool.dump_wal(state_dir, "SWMKEY-1-wrong")

    # decrypt to a plaintext dir readable with no key at all (under
    # tmp_path: the output holds the cluster's full unencrypted state
    # and must not outlive the test)
    out = str(tmp_path / "plain")
    rafttool.decrypt(state_dir, out, key)
    plain = rafttool.dump_wal(out)
    assert any(r.get("type") == "entry" for r in plain)

    # downgrade-key: the daemon restarts WITHOUT the unlock key
    rafttool.downgrade_key(state_dir, key)
    rafttool.renew_certs(state_dir, "")
    m2 = Swarmd(state_dir=state_dir, hostname="m0", manager=True,
                listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m2.start()
    try:
        assert not m2.locked, "downgraded state must open keyless"
        from swarmkit_tpu_torch.models import Service
        poll(lambda: m2.manager.store.view(
            lambda tx: tx.get(Service, svc.id)) is not None,
            msg="state survives the tooling round-trip")
    finally:
        m2.stop()


# ------------------------------- each package's rafttool on the other's dir

def sealed_state_dir(name, state_dir):
    """A manager daemon of package ``name`` (the port's with
    ``device="cpu"``) on ``state_dir``: two services made through its
    control API, a snapshot after every applied entry, then stopped.
    Its WAL and snapshot are sealed under the persisted CA key."""
    mod = importlib.import_module(f"{name}.swarmd")
    m = importlib.import_module(f"{name}.models")
    kw = {"device": "cpu"} if name == PORT else {}
    d = mod.Swarmd(state_dir=state_dir, hostname="m0", manager=True,
                   listen_remote_api=("127.0.0.1", 0),
                   use_device_scheduler=False, **kw)
    d.start()
    try:
        d.raft_node.snapshot_interval = 1
        api = d.manager.control_api
        for svc, replicas in (("web", 3), ("db", 1)):
            api.create_service(m.ServiceSpec(
                annotations=m.Annotations(name=svc),
                task=m.TaskSpec(container=m.ContainerSpec(image="nginx")),
                mode=m.ServiceMode.REPLICATED,
                replicated=m.ReplicatedService(replicas=replicas)))
        poll(lambda: d.raft_node.stats["snapshots"] >= 2,
             msg="snapshots after the writes")
    finally:
        d.stop()


@requires_crypto
@pytest.mark.parametrize("writer", [PORT, REF])
def test_rafttools_read_each_others_sealed_dirs(writer, tmp_path, capsys):
    """The reference's rafttool reads what a port daemon sealed and the
    port's reads what a reference daemon sealed: ``dump-object``,
    ``dump-snapshot`` and ``dump-wal`` print the same through both."""
    state_dir = str(tmp_path / "m0")
    sealed_state_dir(writer, state_dir)
    printed = {}
    for reader in (PORT, REF):
        tool = importlib.import_module(f"{reader}.rafttool")
        for cmd in (["dump-object", state_dir, "services"],
                    ["dump-snapshot", state_dir], ["dump-wal", state_dir]):
            assert tool.main(cmd) == 0
            printed[reader, cmd[0]] = capsys.readouterr().out
    for cmd in ("dump-object", "dump-snapshot", "dump-wal"):
        assert printed[PORT, cmd] == printed[REF, cmd], cmd
    services = [json.loads(line) for line in
                printed[PORT, "dump-object"].splitlines()]
    replicas = {o["spec"]["annotations"]["name"]:
                o["spec"]["replicated"]["replicas"] for o in services}
    assert replicas == {"web": 3, "db": 1}
    wal = [json.loads(line) for line in
           printed[PORT, "dump-wal"].splitlines()]
    assert all(r.get("actions") != "<undecodable>" for r in wal)

