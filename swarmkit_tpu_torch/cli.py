"""swarmctl-equivalent operator CLI over the control API.

Reference: swarmd/cmd/swarmctl (service/node/task/secret/config/cluster
subcommands).

``run_command(argv, api)`` parses and executes one command against a
ControlAPI and returns the rendered output — the same surface the
reference's cobra commands offer, minus the network hop (the gRPC client
slots in where ``api`` is passed).  ``main()`` runs a self-contained
single-node cluster for demos: swarmd-style bootstrap with an in-process
manager, a fake executor agent, and an interactive prompt.
"""

from __future__ import annotations

import argparse
import shlex
import sys
from typing import List, Optional

from .manager.controlapi import APIError, ControlAPI
from .models.specs import ContainerSpec, SecretSpec, ConfigSpec, ServiceSpec
from .models.types import (
    Annotations, NodeAvailability, TaskState, UpdateConfig, UpdateOrder,
)
from .models import ReplicatedService, ServiceMode, TaskSpec


def _fmt_table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for row in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    return "\n".join(lines)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="swarmctl", add_help=True)
    sub = p.add_subparsers(dest="noun", required=True)

    svc = sub.add_parser("service").add_subparsers(dest="verb",
                                                  required=True)
    create = svc.add_parser("create")
    create.add_argument("--name", required=True)
    create.add_argument("--image", required=True)
    create.add_argument("--replicas", type=int, default=None)
    create.add_argument("--mode", choices=["replicated", "global"],
                        default="replicated")
    create.add_argument("--constraint", action="append", default=[])
    create.add_argument("--env", action="append", default=[],
                        metavar="KEY=VALUE")
    create.add_argument("--label", action="append", default=[],
                        metavar="KEY=VALUE")
    create.add_argument("--publish", action="append", default=[],
                        metavar="PUBLISHED:TARGET[/PROTO]",
                        help="publish a port (e.g. 8080:80 or 53:53/udp)")
    create.add_argument("--network", action="append", default=[],
                        help="attach to a network by name or id")
    create.add_argument("--secret", action="append", default=[],
                        metavar="NAME[:TARGET]")
    create.add_argument("--config", action="append", default=[],
                        metavar="NAME[:TARGET]")
    create.add_argument("--restart-condition",
                        choices=["none", "on-failure", "any"], default=None)
    create.add_argument("--restart-delay", type=float, default=None)
    create.add_argument("--restart-max-attempts", type=int, default=None)
    create.add_argument("--csi-volume", action="append", default=[],
                        metavar="SOURCE:TARGET",
                        help="mount a CSI volume (source = volume name or "
                             "group:<group>) at TARGET in the container")
    svc.add_parser("ls")
    inspect = svc.add_parser("inspect")
    inspect.add_argument("service")
    scale = svc.add_parser("scale")
    scale.add_argument("target")  # name=replicas
    supdate = svc.add_parser("update")
    supdate.add_argument("service")
    supdate.add_argument("--image", default="")
    supdate.add_argument("--replicas", type=int, default=None)
    supdate.add_argument("--update-parallelism", type=int, default=None)
    supdate.add_argument("--update-delay", type=float, default=None)
    supdate.add_argument("--update-order",
                         choices=["stop-first", "start-first"],
                         default=None)
    supdate.add_argument("--constraint", action="append", default=None,
                         help="replace placement constraints")
    rm = svc.add_parser("rm")
    rm.add_argument("service")
    logs = svc.add_parser("logs")
    logs.add_argument("service")
    logs.add_argument("--duration", type=float, default=2.0,
                      help="seconds to collect live log output for")
    logs.add_argument("--tail", type=int, default=-1,
                      help="last N history messages per task "
                      "(-1 = all retained, 0 = none)")
    logs.add_argument("--since", type=float, default=0.0,
                      help="only history at/after this unix time")
    logs.add_argument("--no-follow", action="store_true",
                      help="print retained history and exit")

    node = sub.add_parser("node").add_subparsers(dest="verb", required=True)
    node.add_parser("ls")
    drain = node.add_parser("drain")
    drain.add_argument("node")
    activate = node.add_parser("activate")
    activate.add_argument("node")
    npause = node.add_parser("pause")
    npause.add_argument("node")
    promote = node.add_parser("promote")
    promote.add_argument("node")
    demote = node.add_parser("demote")
    demote.add_argument("node")
    nrm = node.add_parser("rm")
    nrm.add_argument("node")
    nrm.add_argument("--force", action="store_true")
    ninspect = node.add_parser("inspect")
    ninspect.add_argument("node")

    task = sub.add_parser("task").add_subparsers(dest="verb", required=True)
    tls = task.add_parser("ls")
    tls.add_argument("--service", default="")
    tinspect = task.add_parser("inspect")
    tinspect.add_argument("task")
    trm = task.add_parser("rm")
    trm.add_argument("task")

    secret = sub.add_parser("secret").add_subparsers(dest="verb",
                                                     required=True)
    screate = secret.add_parser("create")
    screate.add_argument("name")
    screate.add_argument("data")
    secret.add_parser("ls")
    srm = secret.add_parser("rm")
    srm.add_argument("secret")
    sinsp = secret.add_parser("inspect")
    sinsp.add_argument("secret")

    config = sub.add_parser("config").add_subparsers(dest="verb",
                                                     required=True)
    ccreate = config.add_parser("create")
    ccreate.add_argument("name")
    ccreate.add_argument("data")
    config.add_parser("ls")
    crm = config.add_parser("rm")
    crm.add_argument("config")
    cinsp = config.add_parser("inspect")
    cinsp.add_argument("config")

    network = sub.add_parser("network").add_subparsers(dest="verb",
                                                       required=True)
    ncreate = network.add_parser("create")
    ncreate.add_argument("name")
    ncreate.add_argument("--driver", default="overlay")
    ncreate.add_argument("--subnet", default="")
    network.add_parser("ls")
    ninspect = network.add_parser("inspect")
    ninspect.add_argument("network")
    netrm = network.add_parser("rm")
    netrm.add_argument("network")

    volume = sub.add_parser("volume").add_subparsers(dest="verb",
                                                     required=True)
    vcreate = volume.add_parser("create")
    vcreate.add_argument("name")
    vcreate.add_argument("--driver", required=True)
    vcreate.add_argument("--group", default="")
    vcreate.add_argument("--sharing", default="none",
                         choices=["none", "readonly", "onewriter", "all"])
    vcreate.add_argument("--scope", default="single",
                         choices=["single", "multi"])
    volume.add_parser("ls")
    vinspect = volume.add_parser("inspect")
    vinspect.add_argument("volume")
    vdrain = volume.add_parser("drain")
    vdrain.add_argument("volume")
    vrm = volume.add_parser("rm")
    vrm.add_argument("volume")
    vrm.add_argument("--force", action="store_true")

    cluster = sub.add_parser("cluster").add_subparsers(dest="verb",
                                                       required=True)
    cluster.add_parser("ls")
    cluster.add_parser("inspect")
    rotate = cluster.add_parser("rotate-token")
    rotate.add_argument("role", choices=["worker", "manager"])
    cluster.add_parser("rotate-ca")
    autolock = cluster.add_parser("autolock")
    autolock.add_argument("mode", choices=["on", "off"])
    cluster.add_parser("unlock-key")
    cupdate = cluster.add_parser("update")
    cupdate.add_argument("--heartbeat-period", type=float, default=None,
                         help="dispatcher heartbeat period, seconds")
    cupdate.add_argument("--cert-expiry", type=float, default=None,
                         help="node certificate validity, seconds")
    cupdate.add_argument("--task-history-limit", type=int, default=None,
                         help="retained terminal tasks per slot")
    extca = cluster.add_parser("external-ca")
    extca.add_argument("urls", nargs="*",
                       help="CFSSL signer URLs; none = local signing")
    health = cluster.add_parser("health")
    health.add_argument("--service", default="")

    ext = sub.add_parser("extension").add_subparsers(dest="verb",
                                                     required=True)
    ecreate = ext.add_parser("create")
    ecreate.add_argument("name")
    ecreate.add_argument("--description", default="")
    ext.add_parser("ls")
    erm = ext.add_parser("rm")
    erm.add_argument("extension")

    res = sub.add_parser("resource").add_subparsers(dest="verb",
                                                    required=True)
    rcreate = res.add_parser("create")
    rcreate.add_argument("name")
    rcreate.add_argument("kind")
    rcreate.add_argument("--payload", default="")
    rls = res.add_parser("ls")
    rls.add_argument("--kind", default="")
    rrm = res.add_parser("rm")
    rrm.add_argument("resource")
    return p


def _resolve(items, ident, what):
    for obj in items:
        if obj.id == ident or obj.id.startswith(ident):
            return obj
        name = getattr(obj.spec.annotations, "name", "")
        if name == ident:
            return obj
    raise APIError(f"{what} {ident} not found")


def _update_node_spec(api, ident: str, mutate):
    """Read-modify-write a node spec with a bounded retry: agents write
    node status/description concurrently, so a freshly read version can
    be stale by the time the update lands (SequenceConflict semantics).
    Real operators should not have to hand-retry a role or availability
    flip."""
    import time as _time
    last = None
    for _ in range(10):
        n = _resolve(api.list_nodes(), ident, "node")
        spec = n.spec.copy()
        mutate(spec)
        try:
            api.update_node(n.id, n.meta.version.index, spec)
            return n
        except APIError as e:
            if "stale version" not in str(e):
                raise
            last = e
            _time.sleep(0.05)
    raise last


def _resolve_task(api, ident: str):
    """Task lookup by id or unique id prefix (tasks have no names);
    ambiguous prefixes error rather than picking an arbitrary match —
    `task rm` is destructive."""
    if not ident:
        raise APIError("task id required")
    matches = [t for t in api.list_tasks()
               if t.id == ident or t.id.startswith(ident)]
    if not matches:
        raise APIError(f"task {ident} not found")
    if len(matches) > 1 and not any(t.id == ident for t in matches):
        raise APIError(
            f"task prefix {ident} is ambiguous "
            f"({len(matches)} matches)")
    return next((t for t in matches if t.id == ident), matches[0])


def run_command(argv: List[str], api: ControlAPI) -> str:
    """Execute one CLI command; returns rendered output, raises APIError."""
    args = _build_parser().parse_args(argv)

    if args.noun == "service":
        if args.verb == "create":
            # reference: swarmctl service create flag surface
            # (swarmd/cmd/swarmctl/service/flagparser)
            spec = ServiceSpec(
                annotations=Annotations(name=args.name),
                task=TaskSpec(container=ContainerSpec(image=args.image)))
            if args.mode == "global":
                if args.replicas is not None:
                    raise APIError(
                        "--replicas conflicts with --mode global")
                spec.mode = ServiceMode.GLOBAL
            else:
                spec.mode = ServiceMode.REPLICATED
                spec.replicated = ReplicatedService(
                    replicas=1 if args.replicas is None
                    else args.replicas)
            if args.constraint:
                spec.task.placement.constraints = list(args.constraint)
            if args.env:
                for e in args.env:
                    if "=" not in e:
                        raise APIError("--env must be KEY=VALUE")
                spec.task.container.env = list(args.env)
            if args.label:
                labels = {}
                for kv in args.label:
                    k, sep, v = kv.partition("=")
                    if not sep or not k:
                        raise APIError("--label must be KEY=VALUE")
                    labels[k] = v
                spec.annotations.labels = labels
            if args.publish:
                from .models.types import (
                    EndpointSpec, PortConfig, PortProtocol,
                )
                protos = {"tcp": PortProtocol.TCP, "udp": PortProtocol.UDP,
                          "sctp": PortProtocol.SCTP}
                ports = []
                for p in args.publish:
                    spec_part, _, proto = p.partition("/")
                    pub, sep, target = spec_part.partition(":")
                    if not sep or not pub.isdigit() \
                            or not target.isdigit() \
                            or not 1 <= int(pub) <= 65535 \
                            or not 1 <= int(target) <= 65535 \
                            or (proto or "tcp") not in protos:
                        raise APIError(
                            "--publish must be PUBLISHED:TARGET[/PROTO] "
                            "with ports in 1-65535")
                    ports.append(PortConfig(
                        protocol=protos[proto or "tcp"],
                        target_port=int(target),
                        published_port=int(pub)))
                spec.endpoint = EndpointSpec(ports=ports)
            if args.network:
                from .models.types import NetworkAttachmentConfig
                nets = api.list_networks()
                for ref in args.network:
                    n = _resolve(nets, ref, "network")
                    # the allocator reads task-level attachments (VIPs
                    # and per-task addresses key on spec.task.networks)
                    spec.task.networks.append(
                        NetworkAttachmentConfig(target=n.id))
            if args.secret:
                from .models.types import SecretReference
                known = api.list_secrets()
                for ref in args.secret:
                    name, _, target = ref.partition(":")
                    s = _resolve(known, name, "secret")
                    real = s.spec.annotations.name
                    spec.task.container.secrets.append(SecretReference(
                        secret_id=s.id, secret_name=real,
                        target=target or real))
            if args.config:
                from .models.types import ConfigReference
                known = api.list_configs()
                for ref in args.config:
                    name, _, target = ref.partition(":")
                    c = _resolve(known, name, "config")
                    real = c.spec.annotations.name
                    spec.task.container.configs.append(ConfigReference(
                        config_id=c.id, config_name=real,
                        target=target or real))
            if (args.restart_condition is not None
                    or args.restart_delay is not None
                    or args.restart_max_attempts is not None):
                from .models.types import RestartCondition
                rp = spec.task.restart
                if args.restart_condition is not None:
                    rp.condition = {
                        "none": RestartCondition.NONE,
                        "on-failure": RestartCondition.ON_FAILURE,
                        "any": RestartCondition.ANY,
                    }[args.restart_condition]
                if args.restart_delay is not None:
                    rp.delay = args.restart_delay
                if args.restart_max_attempts is not None:
                    rp.max_attempts = args.restart_max_attempts
            if args.csi_volume:
                from .models.types import Mount, MountType
                for m in args.csi_volume:
                    source, sep, target = m.partition(":")
                    if not sep or not source or not target:
                        raise APIError(
                            "--csi-volume must be SOURCE:TARGET")
                    spec.task.container.mounts.append(Mount(
                        type=MountType.CSI, source=source, target=target))
            service = api.create_service(spec)
            return service.id
        if args.verb == "ls":
            services = api.list_services()
            # running/desired counts via the ListServiceStatuses helper
            # (reference: swarmctl service ls REPLICAS column)
            statuses = {}
            lister = getattr(api, "list_service_statuses", None)
            if lister is not None:
                statuses = {st["service_id"]: st
                            for st in lister([s.id for s in services])}
            rows = []
            for s in services:
                st = statuses.get(s.id)
                if st is not None:
                    replicas = (f"{st['running_tasks']}/"
                                f"{st['desired_tasks']}")
                elif s.spec.replicated:
                    replicas = str(s.spec.replicated.replicas)
                else:
                    replicas = "-"
                image = (s.spec.task.container.image
                         if s.spec.task.container else "-")
                rows.append([s.id[:12], s.spec.annotations.name,
                             s.spec.mode.name.lower(), replicas, image])
            return _fmt_table(["ID", "NAME", "MODE", "REPLICAS", "IMAGE"],
                              rows)
        if args.verb == "inspect":
            s = _resolve(api.list_services(), args.service, "service")
            tasks = api.list_tasks(service_id=s.id)
            lines = [f"ID\t\t: {s.id}",
                     f"Name\t\t: {s.spec.annotations.name}",
                     f"Mode\t\t: {s.spec.mode.name.lower()}",
                     f"Tasks\t\t: {len(tasks)}"]
            return "\n".join(lines)
        if args.verb == "scale":
            name, _, replicas = args.target.partition("=")
            if not replicas.isdigit():
                raise APIError("scale target must be <service>=<replicas>")
            s = _resolve(api.list_services(), name, "service")
            if s.spec.mode != ServiceMode.REPLICATED:
                raise APIError(
                    "scale only applies to replicated services")
            spec = s.spec.copy()
            spec.replicated = ReplicatedService(replicas=int(replicas))
            api.update_service(s.id, s.meta.version.index, spec)
            return f"{s.spec.annotations.name} scaled to {replicas}"
        if args.verb == "update":
            # reference: swarmctl service update — spec changes roll out
            # through the update supervisor (parallelism/delay/order from
            # spec.update; see orchestrator/update.py)
            s = _resolve(api.list_services(), args.service, "service")
            spec = s.spec.copy()
            if args.image:
                if spec.task.container is None:
                    raise APIError("service has no container spec")
                spec.task.container.image = args.image
            if args.replicas is not None:
                if spec.mode != ServiceMode.REPLICATED:
                    raise APIError(
                        "--replicas only applies to replicated services")
                spec.replicated = ReplicatedService(replicas=args.replicas)
            if args.constraint is not None:
                spec.task.placement.constraints = list(args.constraint)
            if (args.update_parallelism is not None
                    or args.update_delay is not None
                    or args.update_order is not None):
                uc = spec.update.copy() if spec.update else UpdateConfig()
                if args.update_parallelism is not None:
                    uc.parallelism = args.update_parallelism
                if args.update_delay is not None:
                    uc.delay = args.update_delay
                if args.update_order is not None:
                    uc.order = (UpdateOrder.START_FIRST
                                if args.update_order == "start-first"
                                else UpdateOrder.STOP_FIRST)
                spec.update = uc
            api.update_service(s.id, s.meta.version.index, spec)
            return f"{s.spec.annotations.name} updated"
        if args.verb == "rm":
            s = _resolve(api.list_services(), args.service, "service")
            api.remove_service(s.id)
            return s.id
        if args.verb == "logs":
            # live log collection through the control surface, so it
            # works identically in-process and over TCP (reference:
            # swarmctl service logs over the log broker)
            s = _resolve(api.list_services(), args.service, "service")
            lines = []
            for msg in api.collect_logs(s.id, duration=args.duration,
                                        tail=args.tail, since=args.since,
                                        follow=not args.no_follow):
                text = msg["data"].decode("utf-8", "replace").rstrip()
                for line in text.splitlines():
                    lines.append(
                        f"{s.spec.annotations.name}"
                        f".{msg['task_id'][:8]}@{msg['node_id'][:8]}"
                        f" | {line}")
            return "\n".join(lines)

    if args.noun == "node":
        if args.verb == "ls":
            rows = []
            for n in api.list_nodes():
                rows.append([
                    n.id[:12], n.spec.annotations.name or
                    (n.description.hostname if n.description else ""),
                    n.status.state.name,
                    n.spec.availability.name.lower(),
                    "manager" if n.spec.desired_role else "worker"])
            return _fmt_table(
                ["ID", "NAME", "STATUS", "AVAILABILITY", "ROLE"], rows)
        if args.verb in ("drain", "activate", "pause"):
            # reference: swarmctl node drain/activate/pause (availability
            # flips; PAUSE keeps running tasks but blocks new placements —
            # the scheduler's ReadyFilter requires ACTIVE)
            avail = {
                "drain": NodeAvailability.DRAIN,
                "activate": NodeAvailability.ACTIVE,
                "pause": NodeAvailability.PAUSE,
            }[args.verb]

            def set_avail(spec):
                spec.availability = avail
            n = _update_node_spec(api, args.node, set_avail)
            return f"{n.id} " + {"drain": "drained", "activate": "activated",
                                 "pause": "paused"}[args.verb]
        if args.verb in ("promote", "demote"):
            # reference: swarmctl node promote/demote (flips
            # spec.desired_role; the role manager reconciles raft
            # membership and the node's CA renewal picks up the role)
            from .models.types import NodeRole
            role = (NodeRole.MANAGER if args.verb == "promote"
                    else NodeRole.WORKER)

            def set_role(spec):
                spec.desired_role = role
            n = _update_node_spec(api, args.node, set_role)
            return f"{n.id} " + ("promoted" if args.verb == "promote"
                                 else "demoted")
        if args.verb == "rm":
            n = _resolve(api.list_nodes(), args.node, "node")
            api.remove_node(n.id, force=args.force)
            return n.id
        if args.verb == "inspect":
            n = _resolve(api.list_nodes(), args.node, "node")
            d = n.description
            res = d.resources if d and d.resources else None
            lines = [
                f"ID: {n.id}",
                f"Name: {n.spec.annotations.name or (d.hostname if d else '')}",
                f"Hostname: {d.hostname if d else ''}",
                f"Status: {n.status.state.name}",
                f"Availability: {n.spec.availability.name.lower()}",
                "Role: " + ("manager" if n.spec.desired_role else "worker"),
            ]
            if d and d.platform:
                lines.append(
                    f"Platform: {d.platform.os}/{d.platform.architecture}")
            if res:
                lines.append(
                    f"Resources: {res.nano_cpus / 1e9:g} CPUs / "
                    f"{res.memory_bytes >> 20} MiB")
            if n.spec.annotations.labels:
                lines.append("Labels: " + ", ".join(
                    f"{k}={v}"
                    for k, v in sorted(n.spec.annotations.labels.items())))
            return "\n".join(lines)

    if args.noun == "task":
        if args.verb == "inspect":
            # reference: swarmctl task inspect (task/inspect.go)
            t = _resolve_task(api, args.task)
            lines = [
                f"ID: {t.id}",
                f"Service: {t.service_annotations.name or t.service_id}",
                f"Slot: {t.slot}",
                f"Node: {t.node_id or '-'}",
                f"Status: {t.status.state.name}",
                f"Desired: {t.desired_state.name}",
            ]
            if t.status.message:
                lines.append(f"Message: {t.status.message}")
            if t.status.err:
                lines.append(f"Err: {t.status.err}")
            if t.spec.container is not None:
                lines.append(f"Image: {t.spec.container.image}")
            if t.networks:
                addrs = [a for n in t.networks for a in n.addresses]
                if addrs:
                    lines.append("Addresses: " + ", ".join(addrs))
            return "\n".join(lines)
        if args.verb == "rm":
            # reference: Control.RemoveTask (controlapi task.go) — an
            # operator escape hatch for stuck/historic tasks
            t = _resolve_task(api, args.task)
            api.remove_task(t.id)
            return t.id
        tasks = api.list_tasks()
        if args.service:
            s = _resolve(api.list_services(), args.service, "service")
            tasks = api.list_tasks(service_id=s.id)
        rows = []
        for t in sorted(tasks, key=lambda t: (t.service_id, t.slot)):
            rows.append([
                t.id[:12],
                f"{t.service_annotations.name or t.service_id[:8]}.{t.slot}",
                t.status.state.name,
                t.desired_state.name,
                t.node_id[:12] if t.node_id else "-"])
        return _fmt_table(
            ["ID", "TASK", "STATUS", "DESIRED", "NODE"], rows)

    if args.noun == "secret":
        if args.verb == "create":
            secret = api.create_secret(SecretSpec(
                annotations=Annotations(name=args.name),
                data=args.data.encode()))
            return secret.id
        if args.verb == "ls":
            rows = [[s.id[:12], s.spec.annotations.name]
                    for s in api.list_secrets()]
            return _fmt_table(["ID", "NAME"], rows)
        if args.verb == "rm":
            s = _resolve(api.list_secrets(), args.secret, "secret")
            api.remove_secret(s.id)
            return s.id
        if args.verb == "inspect":
            # reference: swarmctl secret inspect — metadata only, the
            # payload never leaves the manager (secret.go ListSecrets
            # strips Spec.Data)
            s = _resolve(api.list_secrets(), args.secret, "secret")
            return "\n".join([
                f"ID: {s.id}",
                f"Name: {s.spec.annotations.name}",
                f"Created: {s.meta.created_at}",
                f"Version: {s.meta.version.index}"])

    if args.noun == "network":
        from .models.specs import NetworkSpec
        from .models.types import Driver, IPAMConfig, IPAMOptions
        if args.verb == "create":
            ipam = (IPAMOptions(configs=[IPAMConfig(subnet=args.subnet)])
                    if args.subnet else None)
            net = api.create_network(NetworkSpec(
                annotations=Annotations(name=args.name),
                driver_config=Driver(name=args.driver), ipam=ipam))
            return net.id
        if args.verb == "ls":
            rows = []
            for n in api.list_networks():
                driver = (n.spec.driver_config.name
                          if n.spec.driver_config else "-")
                subnets = ",".join(
                    c.subnet for c in (n.spec.ipam.configs
                                       if n.spec.ipam else []) if c.subnet)
                rows.append([n.id[:12], n.spec.annotations.name, driver,
                             subnets or "-"])
            return _fmt_table(["ID", "NAME", "DRIVER", "SUBNETS"], rows)
        if args.verb == "inspect":
            n = _resolve(api.list_networks(), args.network, "network")
            subnets = ",".join(
                c.subnet for c in (n.spec.ipam.configs
                                   if n.spec.ipam else []) if c.subnet)
            return "\n".join([
                f"ID\t\t: {n.id}",
                f"Name\t\t: {n.spec.annotations.name}",
                f"Driver\t\t: "
                f"{n.spec.driver_config.name if n.spec.driver_config else '-'}",
                f"Subnets\t\t: {subnets or '-'}"])
        if args.verb == "rm":
            n = _resolve(api.list_networks(), args.network, "network")
            api.remove_network(n.id)
            return n.id

    if args.noun == "volume":
        from .models.specs import VolumeSpec
        from .models.types import (
            Driver, VolumeAccessMode, VolumeAccessScope, VolumeSharing,
        )
        if args.verb == "create":
            vol = api.create_volume(VolumeSpec(
                annotations=Annotations(name=args.name),
                group=args.group,
                driver=Driver(name=args.driver),
                access_mode=VolumeAccessMode(
                    scope=(VolumeAccessScope.SINGLE_NODE
                           if args.scope == "single"
                           else VolumeAccessScope.MULTI_NODE),
                    sharing=VolumeSharing[args.sharing.upper()])))
            return vol.id
        if args.verb == "ls":
            rows = []
            for v in api.list_volumes():
                state = ("pending delete" if v.pending_delete
                         else ("created" if v.volume_info
                               and v.volume_info.volume_id else "pending"))
                rows.append([
                    v.id[:12], v.spec.annotations.name, v.spec.group or "-",
                    v.spec.driver.name if v.spec.driver else "-",
                    state, str(len(v.publish_status))])
            return _fmt_table(
                ["ID", "NAME", "GROUP", "DRIVER", "STATE", "PUBLISHED"],
                rows)
        if args.verb == "inspect":
            v = _resolve(api.list_volumes(), args.volume, "volume")
            pubs = ", ".join(
                f"{p.node_id[:8]}={p.state.name.lower()}"
                for p in v.publish_status) or "-"
            return "\n".join([
                f"ID\t\t: {v.id}",
                f"Name\t\t: {v.spec.annotations.name}",
                f"Group\t\t: {v.spec.group or '-'}",
                f"Driver\t\t: "
                f"{v.spec.driver.name if v.spec.driver else '-'}",
                f"VolumeID\t: "
                f"{v.volume_info.volume_id if v.volume_info else '-'}",
                f"Published\t: {pubs}"])
        if args.verb == "drain":
            # availability=DRAIN: the volume enforcer evicts users and the
            # CSI manager unpublishes (reference: VolumeAvailability)
            from .models.types import VolumeAvailability
            v = _resolve(api.list_volumes(), args.volume, "volume")
            spec = v.spec.copy()
            spec.availability = int(VolumeAvailability.DRAIN)
            api.update_volume(v.id, v.meta.version.index, spec)
            return f"{v.id} draining"
        if args.verb == "rm":
            v = _resolve(api.list_volumes(), args.volume, "volume")
            api.remove_volume(v.id, force=args.force)
            return v.id

    if args.noun == "cluster":
        if args.verb == "ls":
            # reference: swarmctl cluster ls (cluster/list.go)
            lister = getattr(api, "list_clusters", None)
            clusters = lister() if lister is not None \
                else [api.get_default_cluster()]
            rows = [[c.id[:12], c.spec.annotations.name,
                     f"{c.spec.ca_config.node_cert_expiry / 86400.0:g}d",
                     "on" if c.spec.encryption_config.auto_lock_managers
                     else "off"]
                    for c in clusters]
            return _fmt_table(["ID", "NAME", "CERT-EXPIRY", "AUTOLOCK"],
                              rows)
        c = api.get_default_cluster()
        if args.verb == "inspect":
            jt = c.root_ca.join_tokens if c.root_ca else None
            return "\n".join([
                f"ID\t\t: {c.id}",
                f"Name\t\t: {c.spec.annotations.name}",
                f"Worker token\t: {jt.worker if jt else '-'}",
                f"Manager token\t: {jt.manager if jt else '-'}"])
        if args.verb == "rotate-token":
            from .models.types import NodeRole
            token = api.rotate_join_token(
                NodeRole.MANAGER if args.role == "manager"
                else NodeRole.WORKER)
            return token
        if args.verb == "rotate-ca":
            digest = api.rotate_ca()
            return (f"root CA rotation started (new root {digest}); "
                    "nodes re-certify as they renew")
        if args.verb == "autolock":
            key = api.set_autolock(args.mode == "on")
            if args.mode == "on":
                return ("autolock enabled; unlock key (save it, shown "
                        f"once): {key}")
            return "autolock disabled"
        if args.verb == "unlock-key":
            key = api.get_unlock_key()
            return key or "autolock is not enabled"
        if args.verb == "update":
            # reference: swarmctl cluster update flags (dispatcher
            # heartbeat, CA cert expiry, orchestration history); all are
            # store-watched and take effect live
            c = api.get_default_cluster()
            spec = c.spec.copy()
            changed = []
            if args.heartbeat_period is not None:
                spec.dispatcher.heartbeat_period = args.heartbeat_period
                changed.append(
                    f"heartbeat-period={args.heartbeat_period:g}s")
            if args.cert_expiry is not None:
                spec.ca_config.node_cert_expiry = args.cert_expiry
                changed.append(f"cert-expiry={args.cert_expiry:g}s")
            if args.task_history_limit is not None:
                spec.orchestration.task_history_retention_limit = \
                    args.task_history_limit
                changed.append(
                    f"task-history-limit={args.task_history_limit}")
            if not changed:
                return "nothing to update"
            api.update_cluster(c.id, c.meta.version.index, spec)
            return "updated: " + ", ".join(changed)
        if args.verb == "external-ca":
            # reference: swarmctl cluster update --external-ca; signing
            # delegates to the CFSSL endpoint(s) (ca/external.go)
            c = api.get_default_cluster()
            spec = c.spec.copy()
            spec.ca_config.external_cas = list(args.urls)
            api.update_cluster(c.id, c.meta.version.index, spec)
            if args.urls:
                return "external CA signing: " + ", ".join(args.urls)
            return "external CA signing disabled (local root signs)"
        if args.verb == "health":
            health = getattr(api, "health", None)
            if health is None:
                raise APIError("health probing needs a manager-bound API")
            return health(args.service)

    if args.noun == "extension":
        if args.verb == "create":
            ext = api.create_extension(Annotations(name=args.name),
                                       args.description)
            return ext.id
        if args.verb == "ls":
            rows = [[e.id[:12], e.annotations.name, e.description or "-"]
                    for e in api.list_extensions()]
            return _fmt_table(["ID", "NAME", "DESCRIPTION"], rows)
        if args.verb == "rm":
            e = _resolve(api.list_extensions(), args.extension,
                         "extension")
            api.remove_extension(e.id)
            return e.id

    if args.noun == "resource":
        if args.verb == "create":
            r = api.create_resource(Annotations(name=args.name),
                                    args.kind, args.payload.encode())
            return r.id
        if args.verb == "ls":
            rows = [[r.id[:12], r.annotations.name, r.kind]
                    for r in api.list_resources(kind=args.kind)]
            return _fmt_table(["ID", "NAME", "KIND"], rows)
        if args.verb == "rm":
            r = _resolve(api.list_resources(), args.resource, "resource")
            api.remove_resource(r.id)
            return r.id

    if args.noun == "config":
        if args.verb == "create":
            config = api.create_config(ConfigSpec(
                annotations=Annotations(name=args.name),
                data=args.data.encode()))
            return config.id
        if args.verb == "ls":
            rows = [[c.id[:12], c.spec.annotations.name]
                    for c in api.list_configs()]
            return _fmt_table(["ID", "NAME"], rows)
        if args.verb == "rm":
            c = _resolve(api.list_configs(), args.config, "config")
            api.remove_config(c.id)
            return c.id
        if args.verb == "inspect":
            # reference: swarmctl config inspect — configs are not
            # sensitive, so the payload prints (config/inspect.go)
            c = _resolve(api.list_configs(), args.config, "config")
            return "\n".join([
                f"ID: {c.id}",
                f"Name: {c.spec.annotations.name}",
                f"Version: {c.meta.version.index}",
                "Data: " + c.spec.data.decode("utf-8", "replace")])

    raise APIError("unknown command")


def main() -> None:   # pragma: no cover - interactive demo entry
    """A self-contained single-node cluster with an interactive prompt
    (swarmd + swarmctl in one process)."""
    import tempfile

    from .agent.testutils import TestExecutor
    from .manager.dispatcher import Config_
    from .manager.manager import Manager
    from .node import Node

    manager = Manager(dispatcher_config=Config_(heartbeat_period=1.0))
    manager.run()
    node = Node(TestExecutor(hostname="local"),
                tempfile.mkdtemp(prefix="swarmkit-tpu-"))
    token = manager.root_ca.join_token(0)
    node.load_or_join(manager.ca_server, token)
    node.start(manager.dispatcher, store=manager.store, hostname="local")
    print("single-node cluster up; try: service create --name web "
          "--image nginx --replicas 3 | service ls | task ls | quit")
    try:
        while True:
            try:
                line = input("swarmctl> ").strip()
            except EOFError:
                break
            if not line:
                continue
            if line in ("quit", "exit"):
                break
            try:
                print(run_command(shlex.split(line), manager.control_api))
            except SystemExit:
                pass
            except APIError as e:
                print(f"error: {e}")
    finally:
        node.stop()
        manager.stop()


if __name__ == "__main__":   # pragma: no cover
    main()
