"""Control API: user-facing validated CRUD for every cluster object.

Reference: manager/controlapi/{service,node,secret,config,network,cluster}.go.

Host-callable server object (a gRPC layer can wrap it 1:1).  Validation
messages match the reference byte-for-byte where tests assert on them.
Errors carry gRPC-style codes via exception types: InvalidArgument /
NotFound / AlreadyExists / FailedPrecondition.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from ..models.objects import (
    Cluster, Config, Extension, Network, Node, Resource, Secret, Service,
    Task, Volume,
)
from ..models.specs import (
    ConfigSpec, NetworkSpec, NodeSpec, SecretSpec, ServiceMode, ServiceSpec,
    VolumeSpec,
)
from ..models.types import (
    EndpointResolutionMode, NodeRole, PublishMode, TaskState, Version, now,
)
from ..scheduler import constraint as constraint_mod
from ..scheduler import strategy as strategy_mod
from ..state.store import (
    AlreadyExists as StoreExists, ByKind, ByName, ByNamePrefix,
    ByReferencedSecret, ByReferencedConfig, MemoryStore, NameConflict,
    NotFound as StoreNotFound, SequenceConflict,
)
from ..utils import new_id


class APIError(Exception):
    code = "unknown"


class InvalidArgument(APIError):
    code = "invalid_argument"


class NotFound(APIError):
    code = "not_found"


class AlreadyExists(APIError):
    code = "already_exists"


class FailedPrecondition(APIError):
    code = "failed_precondition"


# reference: manager/controlapi/common.go isValidDNSName
_DNS_NAME = re.compile(r"^[a-zA-Z0-9](?:[-a-zA-Z0-9]*[a-zA-Z0-9])?$")
_SECRET_NAME = re.compile(r"^[a-zA-Z0-9]+(?:[a-zA-Z0-9-_.]*[a-zA-Z0-9])?$")

MAX_SECRET_SIZE = 500 * 1024  # reference: api/validation/secrets.go


def _validate_annotations(ann) -> None:
    if not ann.name:
        raise InvalidArgument("meta: name must be provided")
    if not _DNS_NAME.match(ann.name):
        raise InvalidArgument("name must be valid as a DNS name component")
    if len(ann.name) > 63:
        raise InvalidArgument("name must be 63 characters or fewer")


def _stripped_secret(secret):
    """API-response projection of a secret: the payload never leaves the
    manager — every secret-returning endpoint redacts through this one
    point (reference: secret.go:44,87,143,175)."""
    s = secret.copy()
    s.spec.data = b""
    return s


def _redacted_cluster(cluster):
    """API-response projection of a cluster: signing keys and unlock
    keys never leave the manager (reference: controlapi/cluster.go:252
    redactClusters — strips Spec.CAConfig.SigningCAKey/SigningCACert,
    RootCA.CAKey, RootRotation.CAKey, and omits UnlockKeys and
    NetworkBootstrapKeys; join tokens stay — they're operator-facing)."""
    c = cluster.copy()
    c.spec.ca_config.signing_ca_key = b""
    c.spec.ca_config.signing_ca_cert = b""
    if c.root_ca is not None:
        c.root_ca.ca_key = b""
        c.root_ca.rotation_ca_key = b""
    c.unlock_keys = []
    c.network_bootstrap_keys = []
    return c


def _validate_secret_annotations(ann) -> None:
    if not ann.name:
        raise InvalidArgument("name must be provided")
    if len(ann.name) > 64 or not _SECRET_NAME.match(ann.name):
        raise InvalidArgument(
            "invalid name, only 64 [a-zA-Z0-9-_.] characters allowed, "
            "and the start and end character must be [a-zA-Z0-9]")


def _validate_resources(r) -> None:
    if r is None:
        return
    if r.nano_cpus != 0 and r.nano_cpus < 1e6:
        raise InvalidArgument(
            f"invalid cpu value {r.nano_cpus / 1e9:g}: "
            f"Must be at least {1e6 / 1e9:g}")
    if r.memory_bytes != 0 and r.memory_bytes < 4 * 1024 * 1024:
        raise InvalidArgument(
            f"invalid memory value {r.memory_bytes}: Must be at least 4MiB")


def _validate_task_spec(task_spec) -> None:
    if task_spec.resources is not None:
        _validate_resources(task_spec.resources.limits)
        _validate_resources(task_spec.resources.reservations)
    rp = task_spec.restart
    if rp is not None:
        if rp.delay < 0:
            raise InvalidArgument("TaskSpec: restart-delay cannot be negative")
        if rp.window < 0:
            raise InvalidArgument(
                "TaskSpec: restart-window cannot be negative")
    placement = task_spec.placement
    if placement is not None and placement.constraints:
        try:
            constraint_mod.parse(placement.constraints)
        except constraint_mod.InvalidConstraint as e:
            raise InvalidArgument(str(e))
    if placement is not None:
        name = (placement.strategy or "").lower()
        if name and strategy_mod.resolve(name) is None:
            raise InvalidArgument(
                f"Placement: unknown placement_strategy {name!r} "
                f"(known: {', '.join(sorted(strategy_mod.REGISTRY))})")
        for key, val in (placement.strategy_weights or {}).items():
            if key not in strategy_mod.WEIGHT_KEYS:
                raise InvalidArgument(
                    f"Placement: unknown strategy weight {key!r} "
                    f"(known: {', '.join(strategy_mod.WEIGHT_KEYS)})")
            if not isinstance(val, int) or isinstance(val, bool) \
                    or not 0 <= val <= strategy_mod.W_CLAMP:
                raise InvalidArgument(
                    f"Placement: strategy weight {key!r} must be an "
                    f"integer in [0, {strategy_mod.W_CLAMP}]")
        gang = placement.gang
        if gang is not None:
            if not isinstance(gang.min_size, int) \
                    or isinstance(gang.min_size, bool) \
                    or gang.min_size < 0:
                raise InvalidArgument(
                    "Placement: gang min_size must be a non-negative "
                    "integer")
    c = task_spec.container
    if c is None and task_spec.generic_runtime is None \
            and task_spec.attachment is None:
        raise InvalidArgument("TaskSpec: missing runtime")
    if c is not None:
        if not c.image:
            raise InvalidArgument(
                "ContainerSpec: image reference must be provided")
        mounts = {}
        for m in c.mounts:
            if m.target in mounts:
                raise InvalidArgument(
                    f"ContainerSpec: duplicate mount point: {m.target}")
            mounts[m.target] = m
        targets = {}
        for ref in c.secrets:
            if not ref.secret_id or not ref.secret_name:
                raise InvalidArgument("malformed secret reference")
            if not ref.target:
                raise InvalidArgument(
                    "malformed secret reference, no target provided")
            prev = targets.get(ref.target)
            if prev is not None:
                raise InvalidArgument(
                    f"secret references '{prev}' and '{ref.secret_name}' "
                    f"have a conflicting target: '{ref.target}'")
            targets[ref.target] = ref.secret_name
        targets = {}
        for ref in c.configs:
            if not ref.config_id or not ref.config_name:
                raise InvalidArgument("malformed config reference")
            if not ref.target:
                raise InvalidArgument(
                    "malformed config reference, no target provided")
            prev = targets.get(ref.target)
            if prev is not None:
                raise InvalidArgument(
                    f"config references '{prev}' and '{ref.config_name}' "
                    f"have a conflicting target: '{ref.target}'")
            targets[ref.target] = ref.config_name


def _validate_update(uc) -> None:
    if uc is None:
        return
    if uc.parallelism < 0:
        raise InvalidArgument(
            "TaskSpec: update-parallelism cannot be negative")
    if uc.delay < 0:
        raise InvalidArgument("TaskSpec: update-delay cannot be negative")
    if uc.monitor < 0:
        raise InvalidArgument("TaskSpec: update-monitor cannot be negative")
    if uc.max_failure_ratio < 0 or uc.max_failure_ratio > 1:
        raise InvalidArgument(
            "TaskSpec: update-maxfailureratio cannot be less than 0 "
            "or bigger than 1")


def _validate_endpoint_spec(ep_spec) -> None:
    if ep_spec is None:
        return
    port_set = set()
    for p in ep_spec.ports:
        if p.publish_mode == PublishMode.INGRESS \
                and ep_spec.mode == EndpointResolutionMode.DNSRR \
                and p.published_port:
            raise InvalidArgument(
                "EndpointSpec: port published with ingress mode can't be "
                "used with dnsrr mode")
        key = (p.protocol, p.target_port, p.published_port)
        if key in port_set:
            raise InvalidArgument(
                "EndpointSpec: duplicate published ports provided")
        port_set.add(key)


def _validate_mode(spec: ServiceSpec) -> None:
    if spec.mode == ServiceMode.REPLICATED:
        if spec.replicated is not None and spec.replicated.replicas < 0:
            raise InvalidArgument("Number of replicas must be non-negative")
        if spec.task.restart is not None:
            pass
    elif spec.mode in (ServiceMode.REPLICATED_JOB, ServiceMode.GLOBAL_JOB):
        if spec.update is not None:
            raise InvalidArgument(
                "job-mode services cannot have update options")


def _normalized_service_spec(spec: ServiceSpec) -> ServiceSpec:
    """Private normalized copy of a validated spec.  REPLICATED_JOB
    defaults max_concurrent to total_completions (like the docker CLI)
    so DesiredTasks can report MaxConcurrent directly, matching
    reference ListServiceStatuses (controlapi/service.go:1086).
    Applied on create AND update so stored specs are always normalized."""
    spec = spec.copy()
    if spec.mode == ServiceMode.REPLICATED_JOB \
            and spec.replicated_job is not None \
            and not spec.replicated_job.max_concurrent:
        spec.replicated_job.max_concurrent = \
            spec.replicated_job.total_completions
    return spec


def validate_service_spec(spec: Optional[ServiceSpec]) -> None:
    """reference: service.go:527 validateServiceSpec."""
    if spec is None:
        raise InvalidArgument("invalid argument")
    _validate_annotations(spec.annotations)
    _validate_task_spec(spec.task)
    _validate_mode(spec)
    if spec.mode not in (ServiceMode.REPLICATED_JOB, ServiceMode.GLOBAL_JOB):
        _validate_update(spec.update)
    _validate_endpoint_spec(spec.endpoint)
    # pipeline DAG edges: local shape checks here; the cross-service
    # cycle walk needs the store (ControlAPI._check_dependency_cycles)
    name = spec.annotations.name
    for dep in spec.depends_on or []:
        if not dep:
            raise InvalidArgument(
                "ServiceSpec: depends_on entries must be non-empty "
                "service names")
        if dep == name:
            raise InvalidArgument(
                f'ServiceSpec: service "{name}" cannot depend on itself')
    if spec.on_upstream_failure not in ("", "halt", "rollback"):
        raise InvalidArgument(
            f"ServiceSpec: unknown on_upstream_failure "
            f"{spec.on_upstream_failure!r} (known: halt, rollback)")


class ControlAPI:
    def __init__(self, store: MemoryStore):
        self.store = store

    # ------------------------------------------------------------- services

    def _check_port_conflicts(self, spec: ServiceSpec,
                              service_id: str) -> None:
        """reference: service.go:570 checkPortConflicts."""
        if spec.endpoint is None:
            return
        ingress, host = set(), set()
        for p in spec.endpoint.ports:
            if not p.published_port:
                continue
            key = (p.protocol, p.published_port)
            if p.publish_mode == PublishMode.INGRESS:
                ingress.add(key)
            elif p.publish_mode == PublishMode.HOST:
                host.add(key)
        if not ingress and not host:
            return

        def in_use(p, service):
            if not p.published_port:
                return
            key = (p.protocol, p.published_port)
            name = service.spec.annotations.name
            if p.publish_mode == PublishMode.HOST:
                if key in ingress:
                    raise InvalidArgument(
                        f"port '{p.published_port}' is already in use by "
                        f"service '{name}' ({service.id}) as a "
                        "host-published port")
            elif p.publish_mode == PublishMode.INGRESS:
                if key in ingress or key in host:
                    raise InvalidArgument(
                        f"port '{p.published_port}' is already in use by "
                        f"service '{name}' ({service.id}) as an ingress "
                        "port")

        for service in self.store.view(lambda tx: tx.find(Service)):
            if service_id and service.id == service_id:
                continue
            if service.spec.endpoint is not None:
                for p in service.spec.endpoint.ports:
                    in_use(p, service)
            if service.endpoint is not None:
                for p in service.endpoint.ports:
                    in_use(p, service)

    def _check_dependency_cycles(self, spec: ServiceSpec,
                                 service_id: str) -> None:
        """Reject a depends_on edge set that would close a cycle through
        the existing services — pipeline DAGs must stay acyclic
        (orchestrator/pipeline.py walks them assuming so).  Edges to
        not-yet-created services are allowed (forward references; the
        gate fails safe while the upstream is absent)."""
        if not spec.depends_on:
            return
        edges: Dict[str, List[str]] = {}
        for service in self.store.view(lambda tx: tx.find(Service)):
            if service_id and service.id == service_id:
                continue
            edges[service.spec.annotations.name] = \
                list(service.spec.depends_on or [])
        name = spec.annotations.name
        edges[name] = list(spec.depends_on)
        path: List[str] = []
        on_path = set()

        def visit(n: str) -> None:
            if n in on_path:
                cycle = path[path.index(n):] + [n]
                raise InvalidArgument(
                    "ServiceSpec: depends_on cycle: "
                    + " -> ".join(cycle))
            if n not in edges:
                return
            path.append(n)
            on_path.add(n)
            for up in edges[n]:
                visit(up)
            on_path.discard(n)
            path.pop()

        visit(name)

    def _check_secret_existence(self, tx, spec: ServiceSpec) -> None:
        c = spec.task.container
        if c is None:
            return
        failed = []
        for ref in c.secrets:
            secret = tx.get(Secret, ref.secret_id)
            if secret is None or \
                    secret.spec.annotations.name != ref.secret_name:
                failed.append(ref.secret_name)
        if failed:
            word = "secret" if len(failed) == 1 else "secrets"
            raise InvalidArgument(f"{word} not found: {', '.join(failed)}")

    def _check_config_existence(self, tx, spec: ServiceSpec) -> None:
        c = spec.task.container
        if c is None:
            return
        failed = []
        for ref in c.configs:
            config = tx.get(Config, ref.config_id)
            if config is None or \
                    config.spec.annotations.name != ref.config_name:
                failed.append(ref.config_name)
        if failed:
            word = "config" if len(failed) == 1 else "configs"
            raise InvalidArgument(f"{word} not found: {', '.join(failed)}")

    def create_service(self, spec: ServiceSpec) -> Service:
        """reference: service.go:727 CreateService."""
        validate_service_spec(spec)
        self._check_port_conflicts(spec, "")
        self._check_dependency_cycles(spec, "")
        spec = _normalized_service_spec(spec)
        service = Service(id=new_id(), spec=spec,
                          spec_version=Version(index=1))

        def cb(tx):
            self._check_secret_existence(tx, spec)
            self._check_config_existence(tx, spec)
            tx.create(service)

        try:
            self.store.update(cb)
        except NameConflict:
            raise AlreadyExists(
                f"service {spec.annotations.name} already exists")
        return self.store.view(lambda tx: tx.get(Service, service.id))

    def get_service(self, service_id: str) -> Service:
        s = self.store.view(lambda tx: tx.get(Service, service_id))
        if s is None:
            raise NotFound(f"service {service_id} not found")
        return s

    def update_service(self, service_id: str, version: int,
                       spec: ServiceSpec, rollback: bool = False) -> Service:
        """reference: service.go:817 UpdateService."""
        validate_service_spec(spec)
        self._check_port_conflicts(spec, service_id)
        self._check_dependency_cycles(spec, service_id)

        def cb(tx):
            service = tx.get(Service, service_id)
            if service is None:
                raise NotFound(f"service {service_id} not found")
            if spec.annotations.name != service.spec.annotations.name:
                raise InvalidArgument("renaming services is not supported")
            if spec.mode != service.spec.mode:
                raise InvalidArgument("service mode change is not allowed")
            self._check_secret_existence(tx, spec)
            self._check_config_existence(tx, spec)
            service = service.copy()
            service.meta.version.index = version
            service.previous_spec = service.spec
            service.previous_spec_version = service.spec_version
            service.spec = _normalized_service_spec(spec)
            service.spec_version = Version(index=self.store.version + 1)
            service.update_status = None
            tx.update(service)
            return service

        try:
            updated = self.store.update(cb)
        except SequenceConflict as e:
            raise FailedPrecondition(str(e))
        return self.store.view(lambda tx: tx.get(Service, updated.id))

    def remove_service(self, service_id: str) -> None:
        def cb(tx):
            if tx.get(Service, service_id) is None:
                raise NotFound(f"service {service_id} not found")
            tx.delete(Service, service_id)

        self.store.update(cb)

    def resume_pipeline(self, service_id: str) -> Service:
        """Operator restart for a halted pipeline stage (the sticky
        halt's one legitimate exit): flips the verdict back to
        "waiting" and resets the poison ledger of the stage AND its
        direct upstreams, stamping ``resumed_at`` so every failure
        observed at/before the resume is forgiven — the poison the
        operator just fixed cannot re-trip the threshold.  Replicas
        zeroed by a rollback halt are NOT restored (rescale
        explicitly); an upstream stage that is itself halted must be
        resumed separately, bottom-up."""
        from ..models.objects import PipelineStatus

        def cb(tx):
            svc = tx.get(Service, service_id)
            if svc is None:
                raise NotFound(f"service {service_id} not found")
            if not svc.spec.depends_on:
                raise FailedPrecondition(
                    f"service {service_id} is not a pipeline stage")
            st = svc.pipeline_status
            state = st.state if st is not None else "waiting"
            if state != "halted":
                raise FailedPrecondition(
                    f'pipeline stage {service_id} is not halted '
                    f'(state "{state}")')
            stamp = now()
            svc = svc.copy()
            svc.pipeline_status = PipelineStatus(
                state="waiting", reason="", updated_at=stamp,
                failed_ids=[], resumed_at=stamp)
            tx.update(svc)
            for dep in svc.spec.depends_on:
                for up in tx.find(Service, ByName(dep)):
                    up = up.copy()
                    up_st = up.pipeline_status
                    up.pipeline_status = PipelineStatus(
                        state=up_st.state if up_st else "waiting",
                        reason=up_st.reason if up_st else "",
                        updated_at=stamp, failed_ids=[],
                        resumed_at=stamp)
                    tx.update(up)

        self.store.update(cb)
        return self.store.view(lambda tx: tx.get(Service, service_id))

    def list_services(self, name_prefix: str = "") -> List[Service]:
        from ..state.store import All, ByNamePrefix
        by = ByNamePrefix(name_prefix) if name_prefix else All()
        return self.store.view(lambda tx: tx.find(Service, by))

    def list_service_statuses(self, service_ids: List[str]) -> List[dict]:
        """Per-service desired/running(/completed) task counts — the
        `service ls` helper (reference: manager/controlapi/service.go:1047
        ListServiceStatuses).  Unknown service ids return zeroed statuses,
        matching the reference; deleted services with surviving tasks
        count 0 desired."""
        from ..models import ServiceMode, TaskState
        from ..state.store import ByService

        def cb(tx):
            out = []
            for sid in service_ids:
                status = {"service_id": sid, "desired_tasks": 0,
                          "running_tasks": 0, "completed_tasks": 0}
                out.append(status)
                svc = tx.get(Service, sid)
                global_ = False
                job_iteration = None
                if svc is not None:
                    mode = svc.spec.mode
                    if mode == ServiceMode.REPLICATED:
                        status["desired_tasks"] = (
                            svc.spec.replicated.replicas
                            if svc.spec.replicated else 1)
                    elif mode == ServiceMode.REPLICATED_JOB:
                        # MaxConcurrent alone, matching reference
                        # ListServiceStatuses (controlapi/service.go);
                        # total_completions is not a desired-slot count
                        job = svc.spec.replicated_job
                        status["desired_tasks"] = (
                            job.max_concurrent if job else 0)
                    else:
                        global_ = True
                    if svc.job_status is not None:
                        job_iteration = svc.job_status.job_iteration.index
                for t in tx.find(Task, ByService(sid)):
                    if job_iteration is not None:
                        if (t.job_iteration is None
                                or t.job_iteration.index != job_iteration):
                            continue
                        if t.status.state == TaskState.COMPLETE:
                            status["completed_tasks"] += 1
                    if t.status.state == TaskState.RUNNING:
                        status["running_tasks"] += 1
                    if global_ and t.desired_state == TaskState.RUNNING:
                        status["desired_tasks"] += 1
                    if (global_
                            and t.status.state != TaskState.COMPLETE
                            and t.desired_state == TaskState.COMPLETE):
                        status["desired_tasks"] += 1
            return out

        return self.store.view(cb)

    # ---------------------------------------------------------------- nodes

    def get_node(self, node_id: str) -> Node:
        n = self.store.view(lambda tx: tx.get(Node, node_id))
        if n is None:
            raise NotFound(f"node {node_id} not found")
        return n

    def list_nodes(self) -> List[Node]:
        return self.store.view(lambda tx: tx.find(Node))

    def update_node(self, node_id: str, version: int,
                    spec: NodeSpec) -> Node:
        """reference: node.go:203 UpdateNode."""
        def cb(tx):
            node = tx.get(Node, node_id)
            if node is None:
                raise NotFound(f"node {node_id} not found")
            if spec.desired_role != node.spec.desired_role \
                    and node.spec.desired_role == NodeRole.MANAGER:
                managers = [n for n in tx.find(Node)
                            if n.spec.desired_role == NodeRole.MANAGER]
                if len(managers) <= 1:
                    raise FailedPrecondition(
                        "attempting to demote the last manager of the swarm")
            node = node.copy()
            node.meta.version.index = version
            node.spec = spec.copy()
            tx.update(node)
            return node

        try:
            updated = self.store.update(cb)
        except SequenceConflict as e:
            raise FailedPrecondition(str(e))
        return self.store.view(lambda tx: tx.get(Node, updated.id))

    def remove_node(self, node_id: str, force: bool = False) -> None:
        """reference: node.go:294 RemoveNode."""
        from ..models.types import NodeState

        def cb(tx):
            node = tx.get(Node, node_id)
            if node is None:
                raise NotFound(f"node {node_id} not found")
            if not force:
                if node.spec.desired_role == NodeRole.MANAGER:
                    raise FailedPrecondition(
                        f"node {node_id} is a cluster manager and is a "
                        "member of the raft cluster. It must be demoted to "
                        "worker before removal")
                if node.status.state != NodeState.DOWN:
                    raise FailedPrecondition(
                        f"node {node_id} is not down and can't be removed")
            tx.delete(Node, node_id)

        self.store.update(cb)

    # --------------------------------------------------------------- secrets

    def create_secret(self, spec: SecretSpec) -> Secret:
        _validate_secret_annotations(spec.annotations)
        if spec.driver is not None and spec.driver.name:
            # driver-backed secrets carry no payload — the value comes
            # from the provider plugin at assignment time
            # (reference: secret.go:251 validateSecretSpec driver branch)
            if spec.data:
                raise InvalidArgument(
                    "driver-backed secrets must not carry data")
        elif not spec.data or len(spec.data) >= MAX_SECRET_SIZE:
            raise InvalidArgument(
                f"secret data must be larger than 0 and less than "
                f"{MAX_SECRET_SIZE} bytes")
        secret = Secret(id=new_id(), spec=spec.copy())
        try:
            self.store.update(lambda tx: tx.create(secret))
        except NameConflict:
            raise AlreadyExists(
                f"secret {spec.annotations.name} already exists")
        return _stripped_secret(
            self.store.view(lambda tx: tx.get(Secret, secret.id)))

    def get_secret(self, secret_id: str) -> Secret:
        s = self.store.view(lambda tx: tx.get(Secret, secret_id))
        if s is None:
            raise NotFound(f"secret {secret_id} not found")
        return _stripped_secret(s)

    def update_secret(self, secret_id: str, version: int,
                      spec: SecretSpec) -> Secret:
        def cb(tx):
            secret = tx.get(Secret, secret_id)
            if secret is None:
                raise NotFound(f"secret {secret_id} not found")
            if spec.annotations.name != secret.spec.annotations.name \
                    or (spec.data and spec.data != secret.spec.data):
                raise InvalidArgument("only updates to Labels are allowed")
            secret = secret.copy()
            secret.meta.version.index = version
            secret.spec.annotations.labels = dict(spec.annotations.labels)
            tx.update(secret)
            return secret

        try:
            return _stripped_secret(self.store.update(cb))
        except SequenceConflict as e:
            raise FailedPrecondition(str(e))

    def remove_secret(self, secret_id: str) -> None:
        def check(tx):
            secret = tx.get(Secret, secret_id)
            if secret is None:
                raise NotFound(f"secret {secret_id} not found")
            return secret, tx.find(Task, ByReferencedSecret(secret_id))

        secret, tasks = self.store.view(check)
        services = sorted({t.service_annotations.name for t in tasks
                           if t.service_id})
        if services:
            word = "service" if len(services) == 1 else "services"
            raise InvalidArgument(
                f"secret '{secret.spec.annotations.name}' is in use by the "
                f"following {word}: {', '.join(services)}")

        def cb(tx):
            if tx.get(Secret, secret_id) is None:
                raise NotFound(f"secret {secret_id} not found")
            tx.delete(Secret, secret_id)

        self.store.update(cb)

    def list_secrets(self) -> List[Secret]:
        secrets = self.store.view(lambda tx: tx.find(Secret))
        return [_stripped_secret(s) for s in secrets]

    # --------------------------------------------------------------- configs

    def create_config(self, spec: ConfigSpec) -> Config:
        _validate_secret_annotations(spec.annotations)
        if not spec.data or len(spec.data) >= MAX_SECRET_SIZE:
            raise InvalidArgument(
                f"config data must be larger than 0 and less than "
                f"{MAX_SECRET_SIZE} bytes")
        config = Config(id=new_id(), spec=spec.copy())
        try:
            self.store.update(lambda tx: tx.create(config))
        except NameConflict:
            raise AlreadyExists(
                f"config {spec.annotations.name} already exists")
        return self.store.view(lambda tx: tx.get(Config, config.id))

    def get_config(self, config_id: str) -> Config:
        c = self.store.view(lambda tx: tx.get(Config, config_id))
        if c is None:
            raise NotFound(f"config {config_id} not found")
        return c

    def update_config(self, config_id: str, version: int,
                      spec: ConfigSpec) -> Config:
        def cb(tx):
            config = tx.get(Config, config_id)
            if config is None:
                raise NotFound(f"config {config_id} not found")
            if spec.annotations.name != config.spec.annotations.name \
                    or (spec.data and spec.data != config.spec.data):
                raise InvalidArgument("only updates to Labels are allowed")
            config = config.copy()
            config.meta.version.index = version
            config.spec.annotations.labels = dict(spec.annotations.labels)
            tx.update(config)
            return config

        try:
            return self.store.update(cb)
        except SequenceConflict as e:
            raise FailedPrecondition(str(e))

    def remove_config(self, config_id: str) -> None:
        def check(tx):
            config = tx.get(Config, config_id)
            if config is None:
                raise NotFound(f"config {config_id} not found")
            return config, tx.find(Task, ByReferencedConfig(config_id))

        config, tasks = self.store.view(check)
        services = sorted({t.service_annotations.name for t in tasks
                           if t.service_id})
        if services:
            word = "service" if len(services) == 1 else "services"
            raise InvalidArgument(
                f"config '{config.spec.annotations.name}' is in use by the "
                f"following {word}: {', '.join(services)}")

        def cb(tx):
            if tx.get(Config, config_id) is None:
                raise NotFound(f"config {config_id} not found")
            tx.delete(Config, config_id)

        self.store.update(cb)

    def list_configs(self) -> List[Config]:
        return self.store.view(lambda tx: tx.find(Config))

    # -------------------------------------------------------------- networks

    def create_network(self, spec: NetworkSpec) -> Network:
        _validate_annotations(spec.annotations)
        network = Network(id=new_id(), spec=spec.copy())
        try:
            self.store.update(lambda tx: tx.create(network))
        except NameConflict:
            raise AlreadyExists(
                f"network {spec.annotations.name} already exists")
        return self.store.view(lambda tx: tx.get(Network, network.id))

    def get_network(self, network_id: str) -> Network:
        n = self.store.view(lambda tx: tx.get(Network, network_id))
        if n is None:
            raise NotFound(f"network {network_id} not found")
        return n

    def remove_network(self, network_id: str) -> None:
        from ..state.store import ByReferencedNetwork

        def check(tx):
            network = tx.get(Network, network_id)
            if network is None:
                raise NotFound(f"network {network_id} not found")
            return tx.find(Service, ByReferencedNetwork(network_id))

        services = self.store.view(check)
        if services:
            raise FailedPrecondition(
                f"network {network_id} is in use by service "
                f"{services[0].id}")

        def cb(tx):
            if tx.get(Network, network_id) is None:
                raise NotFound(f"network {network_id} not found")
            tx.delete(Network, network_id)

        self.store.update(cb)

    def list_networks(self) -> List[Network]:
        return self.store.view(lambda tx: tx.find(Network))

    # --------------------------------------------------------------- cluster

    def get_cluster(self, cluster_id: str) -> Cluster:
        c = self.store.view(lambda tx: tx.get(Cluster, cluster_id))
        if c is None:
            raise NotFound(f"cluster {cluster_id} not found")
        return _redacted_cluster(c)

    def list_clusters(self) -> List[Cluster]:
        """reference: manager/controlapi/cluster.go ListClusters."""
        return [_redacted_cluster(c)
                for c in self.store.view(lambda tx: tx.find(Cluster))]

    def get_default_cluster(self) -> Cluster:
        return _redacted_cluster(self._default_cluster_raw())

    def _default_cluster_raw(self) -> Cluster:
        """Unredacted default cluster, for in-process callers that need
        key material (autolock, unlock-key); never served over the wire."""
        clusters = self.store.view(
            lambda tx: tx.find(Cluster, ByName("default")))
        if not clusters:
            raise NotFound("default cluster not found")
        return clusters[0]

    def update_cluster(self, cluster_id: str, version: int, spec) -> Cluster:
        def cb(tx):
            cluster = tx.get(Cluster, cluster_id)
            if cluster is None:
                raise NotFound(f"cluster {cluster_id} not found")
            cluster = cluster.copy()
            cluster.meta.version.index = version
            new_spec = spec.copy()
            # redacted inspect→update round trips blank the signing CA
            # material; empty means "keep current", never "clear"
            # (reference: controlapi/cluster.go redaction note)
            if not new_spec.ca_config.signing_ca_key:
                new_spec.ca_config.signing_ca_key = \
                    cluster.spec.ca_config.signing_ca_key
            if not new_spec.ca_config.signing_ca_cert:
                new_spec.ca_config.signing_ca_cert = \
                    cluster.spec.ca_config.signing_ca_cert
            cluster.spec = new_spec
            tx.update(cluster)
            return cluster

        try:
            return self.store.update(cb)
        except SequenceConflict as e:
            raise FailedPrecondition(str(e))

    # ---------------------------------------------------------------- volumes

    def create_volume(self, spec: VolumeSpec) -> Volume:
        """reference: manager/controlapi/volume.go:15 CreateVolume."""
        if spec is None:
            raise InvalidArgument("spec must not be nil")
        if spec.driver is None or not spec.driver.name:
            raise InvalidArgument("driver must be specified")
        if not spec.annotations.name:
            raise InvalidArgument("meta: name must be provided")
        if spec.access_mode is None:
            raise InvalidArgument("AccessMode must not be nil")
        volume = Volume(id=new_id(), spec=spec.copy())

        def cb(tx):
            # report ALL missing secrets, not just the first
            # (volume.go:41-60)
            missing = [sid for sid in volume.spec.secrets.values()
                       if tx.get(Secret, sid) is None]
            if missing:
                noun = "secret" if len(missing) == 1 else "secrets"
                raise InvalidArgument(
                    f"{noun} not found: {', '.join(missing)}")
            tx.create(volume)

        try:
            self.store.update(cb)
        except NameConflict:
            raise AlreadyExists(
                f"volume {spec.annotations.name} already exists")
        return self.get_volume(volume.id)

    def get_volume(self, volume_id: str) -> Volume:
        v = self.store.view(lambda tx: tx.get(Volume, volume_id))
        if v is None:
            raise NotFound(f"volume {volume_id} not found")
        return v

    def update_volume(self, volume_id: str, version: int,
                      spec: VolumeSpec) -> Volume:
        """Only labels and availability are mutable
        (reference: volume.go:73 UpdateVolume)."""
        def cb(tx):
            v = tx.get(Volume, volume_id)
            if v is None:
                raise NotFound(f"volume {volume_id} not found")
            old = v.spec
            if spec.annotations.name != old.annotations.name:
                raise InvalidArgument("Name cannot be updated")
            if spec.group != old.group:
                raise InvalidArgument("Group cannot be updated")
            if spec.accessibility_requirements != \
                    old.accessibility_requirements:
                raise InvalidArgument(
                    "AccessibilityRequirements cannot be updated")
            if spec.driver != old.driver:
                raise InvalidArgument("Driver cannot be updated")
            if spec.access_mode != old.access_mode:
                raise InvalidArgument("AccessMode cannot be updated")
            if spec.secrets != old.secrets:
                raise InvalidArgument("Secrets cannot be updated")
            if (spec.capacity_min, spec.capacity_max) != \
                    (old.capacity_min, old.capacity_max):
                raise InvalidArgument("CapacityRange cannot be updated")
            v = v.copy()
            # replace only the mutable fields, never the whole spec
            v.spec.annotations.labels = dict(spec.annotations.labels)
            v.spec.availability = spec.availability
            v.meta.version.index = version
            tx.update(v)
            return tx.get(Volume, volume_id)

        try:
            return self.store.update(cb)
        except SequenceConflict as e:
            raise FailedPrecondition(str(e))

    def list_volumes(self, name_prefix: str = "") -> List[Volume]:
        by = ByNamePrefix(name_prefix) if name_prefix else None
        return self.store.view(
            lambda tx: tx.find(Volume, by) if by else tx.find(Volume))

    def remove_volume(self, volume_id: str, force: bool = False) -> None:
        """Mark for deletion (the CSI manager deletes plugin-side first);
        force deletes outright (reference: volume.go:240 RemoveVolume)."""
        def cb(tx):
            v = tx.get(Volume, volume_id)
            if v is None:
                raise NotFound(f"volume {volume_id} not found")
            if force:
                tx.delete(Volume, volume_id)
                return
            if v.publish_status:
                raise FailedPrecondition("volume is still in use")
            v = v.copy()
            v.pending_delete = True
            tx.update(v)

        self.store.update(cb)

    # ------------------------------------------------------------- extensions

    def create_extension(self, annotations, description: str = ""
                         ) -> Extension:
        """reference: manager/controlapi/extension.go:20 CreateExtension."""
        if annotations is None or not annotations.name:
            raise InvalidArgument("extension name must be provided")
        ext = Extension(id=new_id(), annotations=annotations.copy(),
                        description=description)
        try:
            self.store.update(lambda tx: tx.create(ext))
        except NameConflict:
            raise AlreadyExists(
                f"extension {annotations.name} already exists")
        return self.store.view(lambda tx: tx.get(Extension, ext.id))

    def get_extension(self, extension_id: str) -> Extension:
        if not extension_id:
            raise InvalidArgument("extension ID must be provided")
        e = self.store.view(lambda tx: tx.get(Extension, extension_id))
        if e is None:
            raise NotFound(f"extension {extension_id} not found")
        return e

    def list_extensions(self) -> List[Extension]:
        return self.store.view(lambda tx: tx.find(Extension))

    def remove_extension(self, extension_id: str) -> None:
        """Refuses while resources of this kind exist
        (reference: extension.go:76 RemoveExtension)."""
        if not extension_id:
            raise InvalidArgument("extension ID must be provided")

        def cb(tx):
            ext = tx.get(Extension, extension_id)
            if ext is None:
                raise NotFound(
                    f"could not find extension {extension_id}")
            in_use = tx.find(Resource, ByKind(ext.annotations.name))
            if in_use:
                names = ", ".join(
                    r.annotations.name for r in in_use[:10])
                raise InvalidArgument(
                    f"extension {ext.annotations.name} is in use by "
                    f"resources: {names}")
            tx.delete(Extension, extension_id)

        self.store.update(cb)

    # -------------------------------------------------------------- resources

    def create_resource(self, annotations, kind: str,
                        payload: bytes = b"") -> Resource:
        """reference: manager/controlapi/resource.go:20 CreateResource."""
        if annotations is None or not annotations.name:
            raise InvalidArgument("Resource must have a name")
        if not kind:
            raise InvalidArgument("Resource must belong to an Extension")

        res = Resource(id=new_id(), annotations=annotations.copy(),
                       kind=kind, payload=payload)

        def cb(tx):
            # kind must name a registered extension (store.ErrNoKind)
            exts = tx.find(Extension, ByName(kind))
            if not exts:
                raise InvalidArgument(f"Kind {kind} is not registered")
            tx.create(res)

        try:
            self.store.update(cb)
        except NameConflict:
            raise AlreadyExists(
                f"A resource with name {annotations.name} already exists")
        return self.store.view(lambda tx: tx.get(Resource, res.id))

    def get_resource(self, resource_id: str) -> Resource:
        if not resource_id:
            raise InvalidArgument("resource ID must be present")
        r = self.store.view(lambda tx: tx.get(Resource, resource_id))
        if r is None:
            raise NotFound(f"resource {resource_id} not found")
        return r

    def update_resource(self, resource_id: str, version: int,
                        annotations=None,
                        payload: Optional[bytes] = None) -> Resource:
        """Annotations (same name) and payload are mutable
        (reference: resource.go:190 UpdateResource)."""
        def cb(tx):
            r = tx.get(Resource, resource_id)
            if r is None:
                raise NotFound(f"resource {resource_id} not found")
            r = r.copy()
            if annotations is not None:
                if annotations.name != r.annotations.name:
                    raise InvalidArgument("Name cannot be updated")
                r.annotations = annotations.copy()
            if payload is not None:
                r.payload = payload
            r.meta.version.index = version
            tx.update(r)
            return tx.get(Resource, resource_id)

        try:
            return self.store.update(cb)
        except SequenceConflict as e:
            raise FailedPrecondition(str(e))

    def list_resources(self, kind: str = "") -> List[Resource]:
        by = ByKind(kind) if kind else None
        return self.store.view(
            lambda tx: tx.find(Resource, by) if by else tx.find(Resource))

    def remove_resource(self, resource_id: str) -> None:
        if not resource_id:
            raise InvalidArgument("resource ID must be present")

        def cb(tx):
            if tx.get(Resource, resource_id) is None:
                raise NotFound(f"resource {resource_id} not found")
            tx.delete(Resource, resource_id)

        self.store.update(cb)

    # -------------------------------------------------------- token rotation

    def rotate_join_token(self, role) -> str:
        """Rotate the worker/manager join token: new role secret in the
        CA plus the updated token persisted on the cluster object
        (reference: controlapi/cluster.go UpdateCluster w/ rotation flags).
        Requires a manager-bound API (``root_ca`` set)."""
        from ..models.types import JoinTokens
        ca = getattr(self, "root_ca", None)
        if ca is None:
            raise APIError("join-token rotation requires the manager CA")
        role = NodeRole(role)
        token = ca.rotate_join_token(role)

        def cb(tx):
            clusters = tx.find(Cluster, ByName("default"))
            if not clusters:
                raise NotFound("default cluster not found")
            cluster = clusters[0].copy()
            if cluster.root_ca is None:
                raise FailedPrecondition("cluster has no trust root state")
            jt = cluster.root_ca.join_tokens or JoinTokens()
            if role == NodeRole.WORKER:
                jt.worker = token
            else:
                jt.manager = token
            cluster.root_ca.join_tokens = jt
            tx.update(cluster)

        self.store.update(cb)
        return token

    # --------------------------------------------------------------- autolock

    def set_autolock(self, enabled: bool) -> str:
        """Enable/disable manager autolock (reference:
        manager.go:116-120 UnlockKey + controlapi cluster update with
        AutoLockManagers).  Enabling mints an unlock key, stores it in
        the replicated cluster object (sealed at rest by the raft DEK),
        and returns it — managers seal their local key material under it
        and refuse to serve after a restart until unlocked."""
        import os as _os

        # the unlock key is cryptographic key material: it must come
        # from the OS CSPRNG, never a seeded/simulated source
        # swarmlint: disable=determinism-seam
        key = _os.urandom(32).hex() if enabled else ""

        def cb(tx):
            clusters = tx.find(Cluster, ByName("default"))
            if not clusters:
                raise NotFound("default cluster not found")
            cluster = clusters[0].copy()
            cluster.spec.encryption_config.auto_lock_managers = enabled
            from ..models.types import EncryptionKey
            cluster.unlock_keys = (
                [EncryptionKey(subsystem="manager", key=key.encode())]
                if enabled else [])
            tx.update(cluster)

        self.store.update(cb)
        return key

    def get_unlock_key(self) -> str:
        """Current unlock key ('' when autolock is off) — operator-only
        (reference: controlapi GetUnlockKey)."""
        cluster = self._default_cluster_raw()
        for ek in cluster.unlock_keys:
            if ek.subsystem == "manager":
                return ek.key.decode()
        return ""

    # ------------------------------------------------------------ CA rotation

    def rotate_ca(self) -> str:
        """Begin a root CA rotation: mint a new root, cross-sign it with
        the old one, switch issuance to the new key, and persist the
        rotation state; the manager's reconciler finalizes once every
        node's cert chains to the new root (reference:
        controlapi/ca_rotation.go newRootRotationObject +
        ca/reconciler.go).  Returns the new root's digest."""
        ca = getattr(self, "root_ca", None)
        if ca is None:
            raise APIError("CA rotation requires the manager CA")
        if ca.rotation is not None:
            raise FailedPrecondition("a root rotation is already running")
        new_key, new_cert, cross = ca.begin_rotation()

        def cb(tx):
            clusters = tx.find(Cluster, ByName("default"))
            if not clusters:
                raise NotFound("default cluster not found")
            cluster = clusters[0].copy()
            state = cluster.root_ca
            if state is None:
                raise FailedPrecondition("cluster has no trust root state")
            state.root_rotation_in_progress = True
            state.rotation_ca_key = new_key
            state.rotation_ca_cert = new_cert
            state.cross_signed_ca_cert = cross
            state.last_forced_rotation += 1
            tx.update(cluster)

        try:
            self.store.update(cb)
        except Exception:
            ca.rotation = None   # roll back the in-memory switch
            raise
        from ..security.ca import cert_digest
        return cert_digest(new_cert)

    # ----------------------------------------------------------------- tasks

    def get_task(self, task_id: str) -> Task:
        t = self.store.view(lambda tx: tx.get(Task, task_id))
        if t is None:
            raise NotFound(f"task {task_id} not found")
        return t

    def collect_logs(self, service_id: str, duration: float = 2.0,
                     tail: int = -1, since: float = 0.0,
                     follow: bool = True, streams=None) -> List[dict]:
        """Collect log output for a service (reference: swarmctl service
        logs over the log broker, api/logbroker.proto
        LogSubscriptionOptions).  History replays per tail/since; with
        ``follow`` live output is then collected for up to ``duration``
        seconds.  Returns [{task_id, node_id, stream, data(bytes)}], in
        arrival order.  Only meaningful on the leader (the broker agents
        publish to); bounded so one call can't pin a server thread.  The
        collection deadline reads the models.types.now() seam, so a
        simulated control API follows logs in virtual time."""
        from ..models.types import now as _now

        broker = getattr(self, "log_broker", None)
        if broker is None:
            raise APIError("log broker unavailable on this manager")
        from .logbroker import LogSelector, LogSubscriptionOptions
        duration = min(max(duration, 0.0), 30.0)
        stream = broker.subscribe_logs(
            LogSelector(service_ids=[service_id]),
            options=LogSubscriptionOptions(
                streams=list(streams or []), follow=follow,
                tail=tail, since=since))
        out: List[dict] = []
        try:
            # history backlog is pre-buffered at subscribe time: drain it
            # fully BEFORE the live-collection window starts, so a short
            # duration can never truncate the tail/since replay.  Bounded
            # by the backlog size snapshotted at subscribe — with follow
            # a producer outpacing the 10ms poll must not extend this
            # phase past the replay (live output belongs to the
            # duration-bounded window below)
            remaining = getattr(stream, "backlog_count", 0) \
                if follow else None
            while remaining is None or remaining > 0:
                try:
                    msg = stream.get(timeout=0.01)
                except Exception:   # empty (timeout) or closed (no follow)
                    break
                if remaining is not None:
                    remaining -= 1
                out.append({"task_id": msg.task_id,
                            "node_id": msg.node_id,
                            "stream": msg.stream, "data": msg.data})
            deadline = _now() + duration
            while follow and _now() < deadline:
                try:
                    msg = stream.get(timeout=max(
                        0.05, deadline - _now()))
                except TimeoutError:
                    break
                except Exception:      # broker closed mid-collection
                    break
                out.append({"task_id": msg.task_id,
                            "node_id": msg.node_id,
                            "stream": msg.stream, "data": msg.data})
        finally:
            try:
                stream.close()
            except Exception:
                pass
        return out

    def list_tasks(self, service_id: str = "", node_id: str = "") -> List[Task]:
        from ..state.store import All, ByNode, ByService
        if service_id:
            by = ByService(service_id)
        elif node_id:
            by = ByNode(node_id)
        else:
            by = All()
        return self.store.view(lambda tx: tx.find(Task, by))

    def remove_task(self, task_id: str) -> None:
        def cb(tx):
            if tx.get(Task, task_id) is None:
                raise NotFound(f"task {task_id} not found")
            tx.delete(Task, task_id)

        self.store.update(cb)
