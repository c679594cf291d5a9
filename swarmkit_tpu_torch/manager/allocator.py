"""Allocator: moves tasks NEW → PENDING by allocating their resources.

Reference: manager/allocator/{allocator.go,network.go,portallocator.go}.

The reference's allocator runs a set of sub-allocators (today: network) that
each *vote* on a task; when every registered voter has approved, the task
moves to PENDING with message "pending task scheduling" (allocator.go:38-48,
network.go:770).  Network allocation itself (VIPs, overlay attachments) is a
pluggable driver that lives outside the core in the reference (libnetwork);
here the network layer is the ``Inert`` implementation plus real **ingress
port bookkeeping**: published ports are assigned from the dynamic range
30000-32767 when unspecified, and conflicts are rejected
(portallocator.go:201).

Service allocation materializes ``service.endpoint`` from the endpoint spec;
task allocation copies the service endpoint onto the task so the scheduler's
host-port filter sees published ports.
"""

from __future__ import annotations

import ipaddress
import logging
import threading
from typing import Dict, List, Optional, Set, Tuple

from ..models.objects import Network, Service, Task
from ..models.types import (
    Endpoint, EndpointSpec, EndpointVIP, IPAMConfig, IPAMOptions,
    NetworkAttachment, PortConfig, PublishMode, TaskState, TaskStatus, now,
)
from ..state.events import Event, EventCommit, EventSnapshotRestore
from ..state.store import Batch, ByName, MemoryStore
from ..state.watch import Closed
from .netdriver import NetworkDriverRegistry

log = logging.getLogger("allocator")

ALLOCATED_STATUS_MESSAGE = "pending task scheduling"  # network.go:21
DYNAMIC_PORT_START = 30000  # portallocator.go (dynamicPortStart)
DYNAMIC_PORT_END = 32767


class PortAllocator:
    """Ingress published-port bookkeeping (reference: portallocator.go)."""

    def __init__(self) -> None:
        self._allocated: Set[Tuple[int, int]] = set()  # (protocol, port)
        self._next_dynamic = DYNAMIC_PORT_START

    def restore(self, endpoint: Optional[Endpoint]) -> None:
        if endpoint is None:
            return
        for p in endpoint.ports:
            if p.publish_mode == PublishMode.INGRESS and p.published_port:
                self._allocated.add((p.protocol, p.published_port))

    def release(self, endpoint: Optional[Endpoint]) -> None:
        if endpoint is None:
            return
        for p in endpoint.ports:
            if p.publish_mode == PublishMode.INGRESS and p.published_port:
                self._allocated.discard((p.protocol, p.published_port))

    def allocate(self, spec_ports: List[PortConfig]) -> List[PortConfig]:
        """Resolve a port list: keep user-specified ports (conflict =
        error), assign dynamic ports for unspecified ingress publishes."""
        resolved: List[PortConfig] = []
        taken: List[Tuple[int, int]] = []
        try:
            for p in spec_ports:
                if p.publish_mode != PublishMode.INGRESS:
                    resolved.append(p)
                    continue
                if p.published_port:
                    key = (p.protocol, p.published_port)
                    if key in self._allocated:
                        raise ValueError(
                            f"port '{p.published_port}' is already in use "
                            "by service")
                    self._allocated.add(key)
                    taken.append(key)
                    resolved.append(p)
                else:
                    port = self._find_dynamic(p.protocol)
                    key = (p.protocol, port)
                    self._allocated.add(key)
                    taken.append(key)
                    resolved.append(PortConfig(
                        name=p.name, protocol=p.protocol,
                        target_port=p.target_port, published_port=port,
                        publish_mode=p.publish_mode))
            return resolved
        except ValueError:
            for key in taken:
                self._allocated.discard(key)
            raise

    def _find_dynamic(self, protocol: int) -> int:
        for _ in range(DYNAMIC_PORT_END - DYNAMIC_PORT_START + 1):
            port = self._next_dynamic
            self._next_dynamic += 1
            if self._next_dynamic > DYNAMIC_PORT_END:
                self._next_dynamic = DYNAMIC_PORT_START
            if (protocol, port) not in self._allocated:
                return port
        raise ValueError("dynamic port space exhausted")



class IPAM:
    """Subnet + address allocator over the cluster's default address pool
    (reference: manager/allocator/cnmallocator + ipamapi default-addr-pool
    semantics: carve /subnet_size subnets out of the pool, hand out VIPs
    and per-task addresses from each network's subnet; .1 is the
    gateway)."""

    def __init__(self, pools: Optional[List[str]] = None,
                 subnet_size: int = 24):
        self.pools = [ipaddress.ip_network(p)
                      for p in (pools or ["10.0.0.0/8"])]
        self.subnet_size = subnet_size
        self.subnets: Dict[str, object] = {}      # network_id -> IPv4Network
        self._used_ips: Dict[str, set] = {}       # network_id -> {int, ...}

    # ------------------------------------------------------------- networks

    def allocate_network(self, net: Network) -> IPAMOptions:
        """Pick the network's subnet: the spec's explicit one when given,
        else the next free slice of the pool."""
        spec_ipam = getattr(net.spec, "ipam", None)
        subnet = None
        gateway = ""
        if spec_ipam and spec_ipam.configs:
            cfg = spec_ipam.configs[0]
            if cfg.subnet:
                subnet = ipaddress.ip_network(cfg.subnet)
                gateway = cfg.gateway
        taken = list(self.subnets.values())
        if subnet is not None:
            # explicit subnet: reject overlap with any registered network
            if any(subnet.overlaps(sn) for sn in taken):
                raise ValueError(
                    f"subnet {subnet} overlaps an allocated network")
        else:
            for pool in self.pools:
                for cand in pool.subnets(new_prefix=self.subnet_size):
                    if not any(cand.overlaps(sn) for sn in taken):
                        subnet = cand
                        break
                if subnet is not None:
                    break
            if subnet is None:
                raise ValueError("address pool exhausted")
        if not gateway:
            gateway = str(next(subnet.hosts()))
        self.subnets[net.id] = subnet
        used = self._used_ips.setdefault(net.id, set())
        used.add(int(ipaddress.ip_address(gateway)))
        return IPAMOptions(configs=[IPAMConfig(
            subnet=str(subnet), gateway=gateway)])

    def restore_network(self, net: Network) -> None:
        if net.ipam and net.ipam.configs and net.ipam.configs[0].subnet:
            cfg = net.ipam.configs[0]
            self.subnets[net.id] = ipaddress.ip_network(cfg.subnet)
            used = self._used_ips.setdefault(net.id, set())
            if cfg.gateway:
                used.add(int(ipaddress.ip_address(cfg.gateway)))

    def release_network(self, network_id: str) -> None:
        self.subnets.pop(network_id, None)
        self._used_ips.pop(network_id, None)

    # ------------------------------------------------------------ addresses

    def allocate_ip(self, network_id: str) -> str:
        """Next free address in the network's subnet, in CIDR form."""
        subnet = self.subnets.get(network_id)
        if subnet is None:
            raise ValueError(f"network {network_id} has no subnet")
        used = self._used_ips.setdefault(network_id, set())
        first = int(subnet.network_address) + 1
        last = int(subnet.broadcast_address) - 1
        for ip in range(first, last + 1):
            if ip not in used:
                used.add(ip)
                return (f"{ipaddress.ip_address(ip)}"
                        f"/{subnet.prefixlen}")
        raise ValueError(f"subnet {subnet} exhausted")

    def restore_ip(self, network_id: str, addr: str) -> None:
        if not addr:
            return
        used = self._used_ips.setdefault(network_id, set())
        ip = addr.split("/")[0]
        try:
            used.add(int(ipaddress.ip_address(ip)))
        except ValueError:
            pass

    def release_ip(self, network_id: str, addr: str) -> None:
        if not addr:
            return
        used = self._used_ips.get(network_id)
        if used is None:
            return
        try:
            used.discard(
                int(ipaddress.ip_address(addr.split("/")[0])))
        except ValueError:
            pass


class Allocator:
    """Event-loop allocator (reference: allocator.go:82 Run)."""

    def __init__(self, store: MemoryStore,
                 address_pools: Optional[List[str]] = None,
                 subnet_size: int = 24,
                 network_drivers: Optional[NetworkDriverRegistry] = None):
        self.store = store
        self.ports = PortAllocator()
        self.ipam = IPAM(address_pools, subnet_size)
        # pluggable network-driver seam (manager/netdriver.py): the
        # driver named by NetworkSpec.driver_config owns each network's
        # subnet + address lifecycle; the default wraps self.ipam (read
        # through a getter, so _resync's IPAM rebuild stays visible)
        self.net_drivers = network_drivers or NetworkDriverRegistry(
            lambda: self.ipam)
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pending_tasks: Dict[str, Task] = {}
        self._pending_services: Dict[str, Service] = {}
        self._pending_networks: Dict[str, Network] = {}

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name="allocator",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._done.wait(timeout=10)

    def run(self) -> None:
        try:
            def init(tx):
                self._restore_ipam(tx)
                for s in tx.find(Service):
                    self.ports.restore(s.endpoint)
                for s in tx.find(Service):
                    if self._service_needs_allocation(s):
                        self._pending_services[s.id] = s
                for t in tx.find(Task):
                    if t.status.state == TaskState.NEW:
                        self._pending_tasks[t.id] = t

            # accepts_blocks: allocation triggers on NEW tasks and
            # deletes; assignment blocks are updates past PENDING
            _, sub = self.store.view_and_watch(init, accepts_blocks=True)
            try:
                self._tick()
                while not self._stop.is_set():
                    try:
                        event = sub.get(timeout=0.2)
                    except TimeoutError:
                        continue
                    except Closed:
                        return
                    if isinstance(event, EventCommit):
                        self._tick()
                    elif isinstance(event, EventSnapshotRestore):
                        self._resync()
                    elif isinstance(event, Event):
                        self._handle_event(event)
            finally:
                self.store.queue.unsubscribe(sub)
        finally:
            self._done.set()

    def _restore_ipam(self, tx) -> None:
        for net in tx.find(Network):
            if net.ipam is not None:
                self.net_drivers.for_network(net).restore_network(net)
            else:
                self._pending_networks[net.id] = net
        drv = self.net_drivers.for_id
        for s in tx.find(Service):
            if s.endpoint is not None:
                for vip in s.endpoint.virtual_ips:
                    drv(vip.network_id).restore_ip(vip.network_id,
                                                   vip.addr)
        for t in tx.find(Task):
            for att in t.networks:
                for addr in att.addresses:
                    drv(att.network_id).restore_ip(att.network_id, addr)

    def _resync(self) -> None:
        self._pending_tasks.clear()
        self._pending_services.clear()
        self._pending_networks.clear()
        self.ports = PortAllocator()
        self.ipam = IPAM([str(p) for p in self.ipam.pools],
                         self.ipam.subnet_size)
        # driver bindings rebuild from the fresh view below (the default
        # driver reads self.ipam through its getter, so the instance
        # swap above is already visible to it)
        self.net_drivers.reset_bindings()

        def init(tx):
            self._restore_ipam(tx)
            for s in tx.find(Service):
                self.ports.restore(s.endpoint)
                if self._service_needs_allocation(s):
                    self._pending_services[s.id] = s
            for t in tx.find(Task):
                if t.status.state == TaskState.NEW:
                    self._pending_tasks[t.id] = t

        self.store.view(init)
        self._tick()

    # ----------------------------------------------------------- event intake

    def _handle_event(self, ev: Event) -> None:
        obj = ev.obj
        if isinstance(obj, Task):
            if ev.action == "delete":
                self._pending_tasks.pop(obj.id, None)
                for att in obj.networks:
                    for addr in att.addresses:
                        self.net_drivers.for_id(att.network_id) \
                            .release_ip(att.network_id, addr)
            elif obj.status.state == TaskState.NEW:
                self._pending_tasks[obj.id] = obj
        elif isinstance(obj, Service):
            if ev.action == "delete":
                self.ports.release(obj.endpoint)
                if obj.endpoint is not None:
                    for vip in obj.endpoint.virtual_ips:
                        self.net_drivers.for_id(vip.network_id) \
                            .release_ip(vip.network_id, vip.addr)
                self._pending_services.pop(obj.id, None)
            elif self._service_needs_allocation(obj):
                self._pending_services[obj.id] = obj
        elif isinstance(obj, Network):
            if ev.action == "delete":
                self.net_drivers.release_binding(obj.id) \
                    .release_network(obj.id)
                self._pending_networks.pop(obj.id, None)
            elif obj.ipam is None:
                self._pending_networks[obj.id] = obj

    @staticmethod
    def _service_needs_allocation(s: Service) -> bool:
        spec_ep = s.spec.endpoint
        have_vips = {v.network_id for v in (s.endpoint.virtual_ips
                                            if s.endpoint else [])}
        if s.spec.task.networks or have_vips:
            # target may be a name; distinct-count suffices for the needs
            # check (exact resolution happens at allocation time) — and a
            # spec with NO networks must shed any lingering VIPs
            want = {c.target for c in s.spec.task.networks}
            if len(have_vips) != len(want):
                return True
        if s.endpoint is None:
            return spec_ep is not None
        spec_ports = list(spec_ep.ports) if spec_ep else []
        have_ports = s.endpoint.ports
        if len(spec_ports) != len(have_ports):
            return True
        have_exact = {(p.protocol, p.target_port, p.publish_mode,
                       p.published_port) for p in have_ports}
        have_any = {(p.protocol, p.target_port, p.publish_mode)
                    for p in have_ports}
        for p in spec_ports:
            if p.published_port:
                # user-specified port: the endpoint must carry exactly it
                if (p.protocol, p.target_port, p.publish_mode,
                        p.published_port) not in have_exact:
                    return True
            else:
                # dynamic port: any allocated published port satisfies it
                if (p.protocol, p.target_port,
                        p.publish_mode) not in have_any:
                    return True
        return False

    # ----------------------------------------------------------------- ticks

    def _tick(self) -> None:
        if self._pending_networks:
            networks, self._pending_networks = self._pending_networks, {}
            self._allocate_networks(networks)
        if self._pending_services:
            services, self._pending_services = self._pending_services, {}
            self._allocate_services(services)
        if self._pending_tasks:
            tasks, self._pending_tasks = self._pending_tasks, {}
            self._allocate_tasks(tasks)

    def _allocate_networks(self, networks: Dict[str, Network]) -> None:
        def cb(batch: Batch) -> None:
            for network in networks.values():
                def one(tx, network=network):
                    cur = tx.get(Network, network.id)
                    if cur is None or cur.ipam is not None:
                        return
                    cur = cur.copy()
                    cfg = getattr(cur.spec, "driver_config", None)
                    if cfg and cfg.name \
                            and not self.net_drivers.known(cfg.name):
                        log.warning("network %s names unknown driver "
                                    "%r; using the default IPAM",
                                    network.id, cfg.name)
                    try:
                        cur.ipam = self.net_drivers.for_network(cur) \
                            .allocate_network(cur)
                    except ValueError as e:
                        log.warning("network %s allocation failed: %s",
                                    network.id, e)
                        return
                    tx.update(cur)
                try:
                    batch.update(one)
                except Exception:
                    log.exception("network allocation failed")

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("network allocation batch failed")

    def _resolve_network_ids(self, tx, attachment_configs):
        """Resolve attachment targets (id or name) to allocated network
        ids; returns None if any referenced network has no subnet yet (the
        commit event for its allocation re-triggers the caller)."""
        ids = []
        for cfg in attachment_configs:
            net = tx.get(Network, cfg.target)
            if net is None:
                found = tx.find(Network, ByName(cfg.target))
                net = found[0] if found else None
            if net is None:
                log.warning("unknown network %r referenced", cfg.target)
                return None
            if net.ipam is None:
                return None   # subnet not carved yet
            ids.append(net.id)
        return ids

    def _allocate_services(self, services: Dict[str, Service]) -> None:
        def cb(batch: Batch) -> None:
            for service in services.values():
                def one(tx, service=service):
                    cur = tx.get(Service, service.id)
                    if cur is None or not self._service_needs_allocation(cur):
                        return
                    cur = cur.copy()
                    old_endpoint = cur.endpoint
                    spec_ep = cur.spec.endpoint
                    # release this service's own ports first so keeping a
                    # port across a spec change doesn't self-conflict;
                    # restore them if the new allocation fails
                    self.ports.release(old_endpoint)
                    try:
                        ports = self.ports.allocate(
                            list(spec_ep.ports) if spec_ep else [])
                    except ValueError as e:
                        self.ports.restore(old_endpoint)
                        log.warning("service %s port allocation failed: %s",
                                    service.id, e)
                        return
                    def unwind_ports():
                        # the freshly allocated ports must not stay
                        # registered when we requeue, or retries
                        # self-conflict on fixed ports / leak dynamics
                        self.ports.release(Endpoint(ports=ports))
                        self.ports.restore(old_endpoint)

                    # virtual IPs on every attached network (reference:
                    # allocator/network.go allocateVIPs; VIP mode only).
                    # Duplicate spec entries resolve to one VIP.
                    net_ids = self._resolve_network_ids(
                        tx, cur.spec.task.networks)
                    if net_ids is None and cur.spec.task.networks:
                        unwind_ports()
                        self._pending_services[cur.id] = cur
                        return
                    net_ids = list(dict.fromkeys(net_ids or []))
                    vips = []
                    fresh = []
                    old_vips = {v.network_id: v
                                for v in (old_endpoint.virtual_ips
                                          if old_endpoint else [])}
                    drv = self.net_drivers.for_id
                    try:
                        for nid in net_ids:
                            if nid in old_vips:
                                vips.append(old_vips.pop(nid))
                                continue
                            # VIP row kept even for addressing-free
                            # drivers (addr ""): the needs-allocation
                            # check counts VIPs per network id
                            vip = EndpointVIP(
                                network_id=nid,
                                addr=drv(nid).allocate_ip(nid))
                            vips.append(vip)
                            fresh.append(vip)
                    except ValueError as e:
                        # exhausted subnet: requeue WITHOUT writing a
                        # partial endpoint (a partial write re-triggers
                        # allocation on its own commit — a hot loop)
                        for vip in fresh:
                            drv(vip.network_id).release_ip(
                                vip.network_id, vip.addr)
                        unwind_ports()
                        log.warning("service %s VIP allocation failed: "
                                    "%s", cur.id, e)
                        return
                    for stale in old_vips.values():
                        drv(stale.network_id).release_ip(
                            stale.network_id, stale.addr)
                    if old_endpoint is not None and not old_vips and \
                            [(p.protocol, p.target_port, p.published_port,
                              p.publish_mode) for p in ports] == \
                            [(p.protocol, p.target_port, p.published_port,
                              p.publish_mode)
                             for p in old_endpoint.ports] and \
                            {(v.network_id, v.addr) for v in vips} == \
                            {(v.network_id, v.addr)
                             for v in old_endpoint.virtual_ips}:
                        # nothing actually changed (e.g. the intake
                        # count-check misfires on duplicate name+id
                        # targets): writing an identical endpoint would
                        # re-trigger allocation on its own commit forever
                        return
                    cur.endpoint = Endpoint(
                        spec=spec_ep.copy() if spec_ep else EndpointSpec(),
                        ports=ports, virtual_ips=vips)
                    tx.update(cur)
                try:
                    batch.update(one)
                except Exception:
                    log.exception("service allocation failed")

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("service allocation batch failed")

    def _allocate_tasks(self, tasks: Dict[str, Task]) -> None:
        def cb(batch: Batch) -> None:
            for task in tasks.values():
                def one(tx, task=task):
                    t = tx.get(Task, task.id)
                    if t is None or t.status.state != TaskState.NEW:
                        return
                    t = t.copy()
                    # propagate the service's allocated endpoint so the
                    # scheduler's host-port filter and the agent see ports
                    if t.service_id:
                        service = tx.get(Service, t.service_id)
                        if service is not None:
                            if self._service_needs_allocation(service):
                                # wait for service allocation first; the
                                # commit event will re-trigger us
                                self._pending_tasks[t.id] = t
                                return
                            if service.endpoint is not None:
                                t.endpoint = service.endpoint.copy()
                    # per-task addresses on each attached network
                    # (reference: allocator/network.go allocateTask)
                    net_cfgs = t.spec.networks
                    if net_cfgs and not t.networks:
                        net_ids = self._resolve_network_ids(tx, net_cfgs)
                        if net_ids is None:
                            self._pending_tasks[t.id] = t
                            return
                        pairs = list({nid: (nid, cfg) for nid, cfg in
                                      zip(net_ids, net_cfgs)}.values())
                        attachments = []
                        drv = self.net_drivers.for_id
                        try:
                            for nid, cfg in pairs:
                                addr = drv(nid).allocate_ip(nid)
                                attachments.append(NetworkAttachment(
                                    network_id=nid,
                                    addresses=[addr] if addr else [],
                                    aliases=list(cfg.aliases)))
                        except ValueError as e:
                            for att in attachments:
                                for a in att.addresses:
                                    drv(att.network_id).release_ip(
                                        att.network_id, a)
                            log.warning("task %s address allocation "
                                        "failed: %s", t.id, e)
                            return
                        t.networks = attachments
                    t.status = TaskStatus(
                        state=TaskState.PENDING, timestamp=now(),
                        message=ALLOCATED_STATUS_MESSAGE)
                    tx.update(t)
                try:
                    batch.update(one)
                except Exception:
                    log.exception("task allocation failed")

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("task allocation batch failed")
