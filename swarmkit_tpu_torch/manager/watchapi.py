"""Watch API: an external event-stream surface over a store's queue.

Reference: manager/watchapi/watch.go:16 (Watch) and :32 (WatchFrom),
selector semantics from watch.proto:74-120 (SelectBy*).

Clients subscribe with per-kind/action/field filters and receive
committed change events.  Every delivered event carries a **resume
token** (``WatchEvent.version``, the store version the change committed
at): passing it back as ``resume_from_version`` replays every change
committed after that version (backed by the store's changelog ring, the
analogue of the reference's raft-log ChangesBetween, raft.go:1617)
before going live.  Version stamping is part of the replicated state —
leader and follower stores stamp identical indices — so a token taken
from one member resumes, gap-free and dup-free, on ANY member's
replicated store: the watch plane survives leader loss by reattaching
elsewhere.  A token older than the retained window raises
``ResumeCompacted`` — the caller must re-list from a current view and
watch from that version, exactly like the reference when the raft log
was compacted (snapshot re-sync).

Filter evaluation is member-agnostic by construction:
``compile_filter`` builds one pure predicate over the event payload
(never over live store rows), shared by leader- and follower-served
streams and by the simulator's continuity checkers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple, Type

from ..state.events import Event, event_version
from ..state.store import MemoryStore
from ..state.watch import Subscription


@dataclass
class WatchRequest:
    kinds: List[Type] = field(default_factory=list)   # [] = all kinds
    actions: List[str] = field(default_factory=list)  # [] = all actions
    id_prefix: str = ""
    name_prefix: str = ""
    # task-shaped selectors (reference: watch.proto SelectByServiceID /
    # SelectByNodeID); objects without the field never match
    service_ids: List[str] = field(default_factory=list)
    node_ids: List[str] = field(default_factory=list)
    # ---- per-kind field filters (watch.proto:74-120 parity) ----
    # exact names (SelectByName; case-insensitive like the store index)
    names: List[str] = field(default_factory=list)
    # (service_id, slot) pairs (SelectBySlot)
    slots: List[Tuple[str, int]] = field(default_factory=list)
    # desired-state ints (SelectByDesiredState)
    desired_states: List[int] = field(default_factory=list)
    # node role / membership ints (SelectByRole / SelectByMembership)
    roles: List[int] = field(default_factory=list)
    memberships: List[int] = field(default_factory=list)
    # resource kind strings (SelectByKind)
    resource_kinds: List[str] = field(default_factory=list)
    # custom-index selectors over annotations.indices (SelectByCustom /
    # SelectByCustomPrefix): (index, value) exact or value-prefix pairs
    custom_indices: List[Tuple[str, str]] = field(default_factory=list)
    custom_index_prefixes: List[Tuple[str, str]] = \
        field(default_factory=list)
    include_old_object: bool = False
    # store version to resume from (None = live-only, no replay)
    resume_from_version: Optional[int] = None


def _annotations(obj: Any) -> Any:
    ann = getattr(obj, "annotations", None)
    if ann is not None:
        return ann
    spec = getattr(obj, "spec", None)
    return getattr(spec, "annotations", None)


def compile_filter(request: WatchRequest) -> Callable[[Any], bool]:
    """One pure predicate over event payloads for this request's
    selectors.  Evaluation never reads live store rows, so the SAME
    filter yields the SAME stream on every member — the property the
    follower-served watch plane (and its no-gap-no-dup checker) rests
    on."""
    kinds = tuple(request.kinds) or None
    actions = set(request.actions) or None
    names = {n.lower() for n in request.names} or None
    slots = set(request.slots) or None
    desired = set(request.desired_states) or None
    roles = set(request.roles) or None
    memberships = set(request.memberships) or None
    rkinds = set(request.resource_kinds) or None
    custom = list(request.custom_indices)
    custom_prefix = list(request.custom_index_prefixes)

    def pred(ev: Any) -> bool:
        if not isinstance(ev, Event):
            return False
        obj = ev.obj
        if kinds is not None and not isinstance(obj, kinds):
            return False
        if actions is not None and ev.action not in actions:
            return False
        if request.id_prefix and not obj.id.startswith(request.id_prefix):
            return False
        if request.name_prefix or names is not None:
            from ..state.store import _obj_name
            name = _obj_name(obj).lower()
            if request.name_prefix and \
                    not name.startswith(request.name_prefix.lower()):
                return False
            if names is not None and name not in names:
                return False
        if request.service_ids and \
                getattr(obj, "service_id", None) \
                not in request.service_ids:
            return False
        if request.node_ids and \
                getattr(obj, "node_id", None) not in request.node_ids:
            return False
        if slots is not None and \
                (getattr(obj, "service_id", None),
                 getattr(obj, "slot", None)) not in slots:
            return False
        if desired is not None:
            ds = getattr(obj, "desired_state", None)
            if ds is None or int(ds) not in desired:
                return False
        if roles is not None:
            spec = getattr(obj, "spec", None)
            role = getattr(spec, "desired_role", None)
            if role is None or int(role) not in roles:
                return False
        if memberships is not None:
            spec = getattr(obj, "spec", None)
            mem = getattr(spec, "membership", None)
            if mem is None or int(mem) not in memberships:
                return False
        if rkinds is not None and \
                getattr(obj, "kind", None) not in rkinds:
            return False
        if custom or custom_prefix:
            ann = _annotations(obj)
            indices = getattr(ann, "indices", None) or {}
            for index, value in custom:
                if indices.get(index) == value:
                    break
            else:
                for index, prefix in custom_prefix:
                    got = indices.get(index)
                    if got is not None and got.startswith(prefix):
                        break
                else:
                    return False
        return True

    return pred


@dataclass
class WatchEvent:
    action: str
    obj: Any
    old: Optional[Any] = None
    #: resume token: the store version this change committed at; pass it
    #: back as ``resume_from_version`` to continue exactly after this
    #: event on any member
    version: int = 0


class ResumeCompacted(Exception):
    """The requested resume version is older than the retained changelog;
    re-list and watch from the current version."""


class WatchServer:
    """Serves watch streams over ONE store — the leader's or, with
    follower-served reads, any member's replicated store (identical
    event payloads and version stamps by the store's convergence
    contract)."""

    def __init__(self, store: MemoryStore):
        self.store = store

    def watch(self, request: WatchRequest) -> "WatchStream":
        pred = compile_filter(request)
        if request.resume_from_version is not None:
            from ..state.store import InvalidStoreAction
            try:
                replay, sub = self.store.watch_from(
                    request.resume_from_version, pred)
            except InvalidStoreAction as e:
                raise ResumeCompacted(str(e))
            replay = [ev for ev in replay if pred(ev)]
        else:
            replay = []
            sub = self.store.queue.subscribe(pred)
        return WatchStream(self, sub, request.include_old_object, replay)


class WatchStream:
    def __init__(self, server: WatchServer, sub: Subscription,
                 include_old: bool, replay: Optional[List[Event]] = None):
        self._server = server
        self._sub = sub
        self._include_old = include_old
        self._replay = list(replay or [])

    def _wrap(self, ev: Event) -> WatchEvent:
        return WatchEvent(ev.action, ev.obj,
                          ev.old if self._include_old else None,
                          version=event_version(ev))

    def get(self, timeout: Optional[float] = None) -> WatchEvent:
        if self._replay:
            return self._wrap(self._replay.pop(0))
        return self._wrap(self._sub.get(timeout=timeout))

    def poll(self) -> Optional[WatchEvent]:
        """Non-blocking ``get``: the next buffered event or None."""
        if self._replay:
            return self._wrap(self._replay.pop(0))
        ev = self._sub.poll()
        return None if ev is None else self._wrap(ev)

    @property
    def closed(self) -> bool:
        """True once the subscription is closed and drained (overflow or
        store shutdown): the consumer must reattach — with its resume
        token, to any member."""
        return not self._replay and self._sub.closed

    def close(self) -> None:
        self._server.store.queue.unsubscribe(self._sub)
