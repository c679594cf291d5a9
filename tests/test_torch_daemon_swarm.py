"""``workload.daemon_swarm`` (the chip's daemon phase, ``chip_smoke.py``
phase 28) on the CPU at three managers and two workers over
``TorchPlanner(device="cpu")``: the create through the CLI and a
``RemoteControlClient``, the leader's failover to a survivor that builds
its own planner, the heal, the scale, and ``rafttool`` on a survivor's
sealed state dir.  The case gets one retry after a failure, as
``tests/conftest.py`` gives the reference's daemon files.
"""

import pytest

from swarmkit_tpu_torch import rafttool, workload
from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY

from test_torch_raft import retried
from test_torch_dispatcher import (  # noqa: F401  (the fixture)
    singletons_left_as_found,
)

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")


@requires_crypto
@retried
def test_daemon_swarm_fails_over_to_a_new_planner(tmp_path):
    """The chip's daemon phase at three managers and two workers: 40
    replicas eight a node, the leading manager's daemon stopped, a
    survivor leading on its own ``TorchPlanner``, the replicas back on
    the four others, 48 after the scale (12 a node unless a node went
    DOWN on the way and came back empty: then as a spread tops up), and
    the sealed state a survivor left read back by ``rafttool``."""
    run = workload.daemon_swarm(str(tmp_path), n_managers=3, n_workers=2,
                                replicas=40, scale_to=48,
                                tools=workload.swarmd_tools("cpu"),
                                snapshot=True)
    assert (run["planner"], run["planner_device"]) == ("TorchPlanner", "cpu")
    assert (run["new_planner"], run["new_planner_device"]) \
        == ("TorchPlanner", "cpu")
    hosts = {"m0", "m1", "m2", "w0", "w1"}
    assert run["stopped"] in ("m0", "m1", "m2")
    assert run["leader"] in hosts - {run["stopped"], "w0", "w1"}
    assert run["per_host"]["create"] == {h: 8 for h in hosts}
    heal = run["per_host"]["heal"]
    assert run["stopped"] not in heal and sum(heal.values()) == 40
    steady = [n for h, n in heal.items() if h not in run["flapped"]]
    assert max(steady) - min(steady) <= 1, heal
    assert {"w0", "w1"} - set(run["on_leader"]) <= set(run["flapped"])
    scaled = run["per_host"]["scale"]
    assert run["stopped"] not in scaled and sum(scaled.values()) == 48
    assert workload.swarm_spread_ok(heal, scaled), (heal, scaled)
    if not run["flapped"]:
        assert scaled == {h: 12 for h in hosts - {run["stopped"]}}
    services = rafttool.dump_objects(run["state_dir"], "services")
    assert [(o["spec"]["annotations"]["name"],
             o["spec"]["replicated"]["replicas"]) for o in services] \
        == [("web", 48)]
    wal = rafttool.dump_wal(run["state_dir"])
    assert all(r.get("actions") != "<undecodable>" for r in wal)


def test_swarm_spread_ok():
    """A spread's scale tops up the least loaded nodes: a node that
    gained ends within one of the least loaded one, whatever it held."""
    assert workload.swarm_spread_ok({"a": 2, "b": 2}, {"a": 3, "b": 3})
    assert workload.swarm_spread_ok({"a": 5, "b": 0}, {"a": 5, "b": 4})
    assert not workload.swarm_spread_ok({"a": 2, "b": 2}, {"a": 5, "b": 3})
    assert not workload.swarm_spread_ok({"a": 5}, {"a": 6, "b": 2})
