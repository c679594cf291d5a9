"""Network-allocator driver seam (ROADMAP item 10).

The reference allocator routes network/address allocation through
pluggable drivers (cnmallocator + ipamapi); ours hard-wired the
built-in IPAM.  This module is the small driver interface the
``Allocator`` now consumes: per-network, the driver named by
``NetworkSpec.driver_config`` owns subnet carving and address
allocation/release.  Two built-ins ship:

* ``ipam`` (default, also the unnamed driver): the existing pool-carving
  IPAM — behavior unchanged for every current workload.
* ``inert``: completes allocation without addressing (empty IPAM config,
  no VIPs/addresses) — for driver-managed networks whose addressing
  happens off-cluster, and the seam's always-available null object.

Tests register fakes via ``NetworkDriverRegistry.register`` and observe
allocate/free calls; the registry remembers which driver allocated each
network id so release paths (which only carry the id) route back to the
owning driver.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..models.objects import Network
from ..models.types import IPAMOptions


class NetworkDriver:
    """Interface one network driver implements (the built-in IPAM's
    shape).  ``allocate_ip``/``release_ip`` cover VIPs and per-task
    addresses alike; an empty string from ``allocate_ip`` means "this
    driver does not address" and the caller attaches no address."""

    name = "driver"

    def allocate_network(self, net: Network) -> IPAMOptions:
        raise NotImplementedError

    def restore_network(self, net: Network) -> None:
        raise NotImplementedError

    def release_network(self, network_id: str) -> None:
        raise NotImplementedError

    def allocate_ip(self, network_id: str) -> str:
        raise NotImplementedError

    def restore_ip(self, network_id: str, addr: str) -> None:
        raise NotImplementedError

    def release_ip(self, network_id: str, addr: str) -> None:
        raise NotImplementedError


class IPAMNetworkDriver(NetworkDriver):
    """The built-in pool-carving IPAM behind the driver interface.
    Holds no state of its own: it reads the allocator's live ``ipam``
    through a getter so a store resync (which rebuilds the IPAM) never
    leaves the driver pointing at a dead instance."""

    name = "ipam"

    def __init__(self, get_ipam: Callable):
        self._get_ipam = get_ipam

    def allocate_network(self, net: Network) -> IPAMOptions:
        return self._get_ipam().allocate_network(net)

    def restore_network(self, net: Network) -> None:
        self._get_ipam().restore_network(net)

    def release_network(self, network_id: str) -> None:
        self._get_ipam().release_network(network_id)

    def allocate_ip(self, network_id: str) -> str:
        return self._get_ipam().allocate_ip(network_id)

    def restore_ip(self, network_id: str, addr: str) -> None:
        self._get_ipam().restore_ip(network_id, addr)

    def release_ip(self, network_id: str, addr: str) -> None:
        self._get_ipam().release_ip(network_id, addr)


class InertNetworkDriver(NetworkDriver):
    """Addressing-free driver: networks allocate (empty IPAM config) so
    dependent services/tasks proceed, but no VIPs or per-task addresses
    are handed out."""

    name = "inert"

    def allocate_network(self, net: Network) -> IPAMOptions:
        return IPAMOptions(configs=[])

    def restore_network(self, net: Network) -> None:
        pass

    def release_network(self, network_id: str) -> None:
        pass

    def allocate_ip(self, network_id: str) -> str:
        return ""

    def restore_ip(self, network_id: str, addr: str) -> None:
        pass

    def release_ip(self, network_id: str, addr: str) -> None:
        pass


class NetworkDriverRegistry:
    """name -> driver, plus the network-id -> driver binding release
    paths need (deletes only carry the id)."""

    def __init__(self, get_ipam: Callable):
        default = IPAMNetworkDriver(get_ipam)
        self._drivers: Dict[str, NetworkDriver] = {
            "": default,
            "default": default,
            IPAMNetworkDriver.name: default,
            InertNetworkDriver.name: InertNetworkDriver(),
        }
        self._by_network: Dict[str, NetworkDriver] = {}

    def register(self, name: str, driver: NetworkDriver) -> None:
        self._drivers[name] = driver

    def known(self, name: str) -> bool:
        return name in self._drivers

    def for_network(self, net: Network) -> NetworkDriver:
        """Resolve (and bind) the driver owning ``net``.  An unknown
        driver name falls back to the default IPAM — allocation must
        not wedge on a typo'd spec; the allocator logs it."""
        cfg = getattr(net.spec, "driver_config", None)
        name = (cfg.name if cfg else "") or ""
        drv = self._drivers.get(name, self._drivers[""])
        self._by_network[net.id] = drv
        return drv

    def for_id(self, network_id: str) -> NetworkDriver:
        return self._by_network.get(network_id, self._drivers[""])

    def release_binding(self, network_id: str) -> NetworkDriver:
        """Unbind a deleted network; returns the driver that owned it
        (the default IPAM when the binding predates this process — its
        release_network no-ops on ids it never carved)."""
        return self._by_network.pop(network_id, self._drivers[""])

    def reset_bindings(self) -> None:
        self._by_network.clear()
