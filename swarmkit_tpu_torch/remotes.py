"""Remotes tracker + connection broker: weighted manager-peer selection.

Reference: remotes/remotes.go (observation-based weights) and
connectionbroker/broker.go (local vs remote pick).

Agents track the set of known managers; every successful interaction
raises a peer's weight toward the maximum, every failure collapses it
toward the minimum, and selection samples proportionally to weight — so
traffic drains away from flapping managers without ever blacklisting them
completely (they can recover).
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Dict, List, Optional, Tuple

from .utils.metrics import registry as _metrics

log = logging.getLogger("remotes")

#: error ``code`` attributes that mean "the session died but the link is
#: healthy" — the failover client re-resolves to a DIFFERENT manager
#: instead of hammering the one that just invalidated the session
SESSION_ERROR_CODES = ("session_invalid", "node_not_registered")


def count_reconnect(reason: str) -> None:
    """One agent reconnect cause, by reason — the weighted-remotes
    observability counter (`swarm_agent_reconnects{reason=}`)."""
    _metrics.counter(f'swarm_agent_reconnects{{reason="{reason}"}}')

# reference: remotes.go DefaultObservationWeight and bounds
DEFAULT_OBSERVATION_WEIGHT = 10
REMOTE_WEIGHT_MAX = 1 << 8
REMOTE_WEIGHT_MIN = -(1 << 8)

# reconnect backoff ladder (agent sessions; reference: agent.go's
# session backoff, hardened with full jitter per the AWS exponential
# backoff guidance so a mass disconnect does not reconnect in lockstep)
RECONNECT_BACKOFF_BASE = 0.1
RECONNECT_BACKOFF_CAP = 8.0

Addr = Tuple[str, int]


def backoff_with_jitter(attempt: int,
                        rng: Optional[random.Random] = None,
                        base: float = RECONNECT_BACKOFF_BASE,
                        cap: float = RECONNECT_BACKOFF_CAP) -> float:
    """Jittered exponential backoff: with ``ceiling = min(cap,
    base * 2^attempt)``, the delay is drawn uniformly from
    ``[0.1 * ceiling, ceiling]`` — AWS-style full jitter, floored at a
    tenth of the ceiling so a long backoff can never collapse into a
    hot reconnect loop.

    ``attempt`` counts consecutive failures starting at 0.  The ceiling
    caps at ``cap`` however large ``attempt`` grows (no overflow: the
    exponent is clamped first).  Drawing through an injected ``rng``
    keeps simulated reconnect storms deterministic per seed while still
    de-synchronizing the fleet: two agents sharing a failure instant
    draw different delays from their own streams.
    """
    rng = rng or random
    ceiling = min(cap, base * (2.0 ** min(attempt, 30)))
    # avoid a zero sleep (a hot reconnect loop) while keeping the
    # spread: the floor is a tenth of the current ceiling
    return ceiling * (0.1 + 0.9 * rng.random())


class NoSuchRemote(Exception):
    pass


class Remotes:
    def __init__(self, *addrs: Addr, rng: Optional[random.Random] = None):
        self._mu = threading.Lock()
        self._weights: Dict[Addr, int] = {
            tuple(a): DEFAULT_OBSERVATION_WEIGHT for a in addrs}
        # injectable rng seam: deterministic peer selection in the sim
        self._rng = rng or random.Random()

    def observe(self, addr: Addr, weight: int = DEFAULT_OBSERVATION_WEIGHT
                ) -> None:
        """Positive observations move toward max, negative toward min
        (reference: remotes.go Observe / ObserveIfExists)."""
        addr = tuple(addr)
        with self._mu:
            if addr not in self._weights and weight < 0:
                # ObserveIfExists semantics: a failure against a peer we
                # no longer track (e.g. just removed after demotion) must
                # not resurrect it into the selection pool
                return
            cur = self._weights.get(addr, 0)
            if weight >= 0:
                self._weights[addr] = min(
                    REMOTE_WEIGHT_MAX, cur + weight)
            else:
                self._weights[addr] = max(
                    REMOTE_WEIGHT_MIN, cur + weight)

    def remove(self, addr: Addr) -> None:
        with self._mu:
            self._weights.pop(tuple(addr), None)

    def weights(self) -> Dict[Addr, int]:
        with self._mu:
            return dict(self._weights)

    def select(self, *excludes: Addr) -> Addr:
        """Weighted random pick (reference: remotes.go Select)."""
        excluded = {tuple(e) for e in excludes}
        with self._mu:
            candidates = [(a, w) for a, w in self._weights.items()
                          if a not in excluded]
            if not candidates:
                raise NoSuchRemote("no remote managers available")
            # shift weights positive; +1 keeps dead peers selectable so
            # they can recover
            lowest = min(w for _, w in candidates)
            total = sum(w - lowest + 1 for _, w in candidates)
            pick = self._rng.uniform(0, total)
            acc = 0.0
            for addr, w in candidates:
                acc += w - lowest + 1
                if pick <= acc:
                    return addr
            return candidates[-1][0]


class PersistentRemotes(Remotes):
    """Remotes whose peer set survives restarts (reference:
    node/node.go:1202 persistentRemotes + state.json): every membership
    change rewrites the state file atomically, and construction merges
    the persisted peers with any seed addresses — so a restarted worker
    can reach the cluster even when its original --join-addr is gone."""

    def __init__(self, path: str, *addrs: Addr,
                 rng: Optional[random.Random] = None):
        self._path = path
        # file writes serialize separately from the weights lock: the
        # session loop and the log shipper can both trigger membership
        # saves concurrently
        self._save_mu = threading.Lock()
        super().__init__(*addrs, rng=rng)
        for addr in self._load():
            if tuple(addr) not in self._weights:
                self._weights[tuple(addr)] = DEFAULT_OBSERVATION_WEIGHT
        self._save()

    def _load(self) -> List[Addr]:
        import json
        try:
            with open(self._path, "r", encoding="utf-8") as f:
                data = json.load(f)
            if not isinstance(data, dict):
                return []
            return [tuple(a) for a in data.get("managers", [])]
        except (OSError, ValueError, TypeError):
            # unreadable or corrupt state file: fall back to the seeds,
            # mirroring _save's tolerance
            return []

    def _save(self) -> None:
        import json
        import os as _os
        with self._save_mu:
            tmp = self._path + ".tmp"
            try:
                _os.makedirs(_os.path.dirname(self._path) or ".",
                             exist_ok=True)
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump({"managers": sorted(
                        list(a) for a in self.weights())}, f)
                _os.replace(tmp, self._path)
            except OSError:
                log.exception("persisting remotes failed")

    def observe(self, addr: Addr,
                weight: int = DEFAULT_OBSERVATION_WEIGHT) -> None:
        known = tuple(addr) in self.weights()
        super().observe(addr, weight)
        if not known and tuple(addr) in self.weights():
            self._save()   # membership change, not just a weight shift

    def remove(self, addr: Addr) -> None:
        known = tuple(addr) in self.weights()
        super().remove(addr)
        if known:
            self._save()


class ConnectionBroker:
    """Picks a manager connection for CA/dispatcher clients: the local
    manager when this node runs one, a weighted remote otherwise
    (reference: connectionbroker/broker.go)."""

    def __init__(self, remotes: Remotes, local_addr: Optional[Addr] = None):
        self.remotes = remotes
        self.local_addr = tuple(local_addr) if local_addr else None

    def select(self, prefer_local: bool = True, *excludes: Addr) -> Addr:
        if prefer_local and self.local_addr is not None:
            return self.local_addr
        try:
            return self.remotes.select(*excludes)
        except NoSuchRemote:
            if excludes:
                return self.remotes.select()  # everything failed: any
            raise

    def observe_success(self, addr: Addr) -> None:
        self.remotes.observe(addr, DEFAULT_OBSERVATION_WEIGHT)

    def observe_failure(self, addr: Addr) -> None:
        self.remotes.observe(addr, -DEFAULT_OBSERVATION_WEIGHT)


class FailoverDispatcherClient:
    """Dispatcher-surface client that fails over between managers using
    the broker: each call picks the current remote; errors down-weight it
    and the next call tries another (the agent's session loop handles the
    re-registration)."""

    def __init__(self, broker: ConnectionBroker, certificate,
                 client_factory=None):
        from .net.client import RemoteDispatcherClient
        self.broker = broker
        self.certificate = certificate
        self._factory = client_factory or (
            lambda addr: RemoteDispatcherClient(addr, self.certificate))
        self._mu = threading.Lock()
        self._current: Optional[Addr] = None
        self._client = None
        self._last_failed: Optional[Addr] = None

    def _get(self):
        with self._mu:
            if self._client is None:
                excludes = (self._last_failed,) if self._last_failed \
                    else ()
                self._current = self.broker.select(
                    False, *excludes)
                self._client = self._factory(self._current)
            return self._current, self._client

    def _rotate(self, addr: Addr) -> None:
        """Drop the cached client so the next call picks a different
        manager (does not itself touch health weights)."""
        with self._mu:
            self._last_failed = addr   # next pick avoids this peer
            if self._current == addr:
                try:
                    self._client.close()
                except Exception:
                    pass
                self._client = None
                self._current = None

    def _fail(self, addr: Addr) -> None:
        self.broker.observe_failure(addr)
        self._rotate(addr)

    def _call(self, method: str, *args, **kwargs):
        addr, client = self._get()
        try:
            result = getattr(client, method)(*args, **kwargs)
            self.broker.observe_success(addr)
            # heartbeat responses piggyback the live manager list: add
            # newcomers so we can fail over to managers that joined after
            # we did, and prune departed ones so removed/demoted managers
            # stop receiving failover picks (reference: session
            # Message.Managers drives the agent's remotes the same way)
            managers = getattr(client, "last_managers", None)
            if managers:
                desired = {tuple(m) for m in managers}
                tracked = self.broker.remotes.weights()
                for m in desired - set(tracked):
                    self.broker.remotes.observe(
                        m, DEFAULT_OBSERVATION_WEIGHT)
                for m in set(tracked) - desired:
                    self.broker.remotes.remove(m)
            return result
        except (ConnectionError, OSError, TimeoutError):
            # only transport failures indict the manager's health;
            # application errors (invalid session etc.) travelled over a
            # perfectly healthy link and must not shift weights
            self._fail(addr)
            raise
        except Exception as e:
            from .net.client import NotLeader
            if isinstance(e, NotLeader):
                # a healthy follower: rotate to another manager without
                # down-weighting it (it may become leader any moment)
                self._rotate(addr)
            elif getattr(e, "code", "") in SESSION_ERROR_CODES:
                # the session is gone (manager teardown, failover hand-
                # off): the next register goes to a DIFFERENT member —
                # re-registering with the invalidator just races its
                # teardown.  No health down-weight: the link was fine.
                self._rotate(addr)
            raise

    def note_session_failure(self) -> None:
        """Agent-side hook for session failures the call path could not
        classify (assignment stream closed server-side): rotate off the
        current manager so the re-register lands elsewhere."""
        with self._mu:
            cur = self._current
        if cur is not None:
            self._rotate(cur)

    def register(self, node_id, description=None):
        return self._call("register", node_id, description=description)

    def heartbeat(self, node_id, session_id):
        return self._call("heartbeat", node_id, session_id)

    @property
    def network_key_delivery(self):
        """Heartbeat piggyback stash (network bootstrap keys) as one
        atomic (clock, keys) pair from whichever inner wire client served
        the last heartbeat — a single locked read so a concurrent
        failover rotation cannot tear the pair apart."""
        with self._mu:
            c = self._client
            if c is None:
                return None, None
            return (getattr(c, "last_key_clock", None),
                    getattr(c, "last_network_keys", None))

    def update_task_status(self, node_id, session_id, updates):
        return self._call("update_task_status", node_id, session_id,
                          updates)

    def open_assignments(self, node_id, session_id):
        return self._call("open_assignments", node_id, session_id)

    def publish_logs(self, node_id, session_id, messages):
        return self._call("publish_logs", node_id, session_id, messages)

    def update_volume_status(self, node_id, session_id, updates):
        return self._call("update_volume_status", node_id, session_id,
                          updates)

    @property
    def last_ca_digest(self) -> str:
        """Active root digest from the latest heartbeat (drives prompt
        renewal when a CA rotation begins)."""
        with self._mu:
            return getattr(self._client, "last_ca_digest", "") or ""

    @property
    def last_role(self):
        """This node's store-reconciled role from the latest heartbeat
        (int NodeRole value), or None before the first heartbeat."""
        with self._mu:
            return getattr(self._client, "last_role", None)

    def reset_connection(self) -> None:
        """Drop the live connection so the next call re-handshakes with
        the (possibly renewed) certificate."""
        with self._mu:
            if self._client is not None:
                try:
                    self._client.close()
                except Exception:
                    pass
                self._client = None
                self._current = None
