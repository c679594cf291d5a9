"""Simulated network + the fault vocabulary.

``SimNetwork`` implements the same two-method transport surface as
``state.raft.transport.LocalNetwork`` (register/send) but routes every
message through the engine's event heap with seeded delay, drop,
duplication, and jitter (jitter IS reordering: two messages on the same
link can land out of order).  Partitions are modeled as link predicates:
symmetric (node isolated both ways), asymmetric (one direction only),
and group partitions (the classic split-brain shape).

The fault taxonomy here is what both scripted scenarios and the fuzzer
compose:

* message faults — drop, delay burst, duplicate, reorder (jitter)
* partitions    — isolate(node), cut(a,b), split(groups), asymmetric
* process faults — crash (volatile state lost, WAL kept), restart,
  crash with WAL tail truncation ("died before fsync")
* timing faults — clock skew as per-component tick-rate multipliers
* leadership    — forced step-down (leader churn)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from ..state.raft.core import Message


class NetConfig:
    """Steady-state link behavior (before injected faults)."""

    def __init__(self, base_delay: float = 0.005, jitter: float = 0.005,
                 drop_p: float = 0.0, dup_p: float = 0.0):
        self.base_delay = base_delay
        self.jitter = jitter
        self.drop_p = drop_p
        self.dup_p = dup_p


class SimNetwork:
    """Engine-driven message router with fault injection."""

    def __init__(self, engine, config: Optional[NetConfig] = None):
        self.engine = engine
        self.config = config or NetConfig()
        self._rng = engine.fork_rng()
        self._handlers: Dict[str, Callable[[Message], None]] = {}
        self._isolated: Set[str] = set()
        self._cut: Set[Tuple[str, str]] = set()      # directed
        self._groups: Optional[List[Set[str]]] = None
        self.stats = {"sent": 0, "delivered": 0, "dropped": 0,
                      "duplicated": 0}

    # --------------------------------------------------- transport surface

    def register(self, node_id: str,
                 handler: Callable[[Message], None]) -> None:
        self._handlers[node_id] = handler

    def unregister(self, node_id: str) -> None:
        self._handlers.pop(node_id, None)

    def send(self, msg: Message) -> None:
        self.stats["sent"] += 1
        if not self._link_up(msg.src, msg.dst):
            self.stats["dropped"] += 1
            return
        if self.config.drop_p and self._rng.random() < self.config.drop_p:
            self.stats["dropped"] += 1
            self.engine.log(f"net drop {msg.src}->{msg.dst} {msg.type}")
            return
        copies = 1
        if self.config.dup_p and self._rng.random() < self.config.dup_p:
            copies = 2
            self.stats["duplicated"] += 1
        for _ in range(copies):
            delay = self.config.base_delay + \
                self._rng.random() * self.config.jitter
            self.engine.after(
                delay, f"deliver {msg.src}->{msg.dst} {msg.type}",
                lambda m=msg: self._deliver(m))

    def _deliver(self, msg: Message) -> None:
        # partition state is re-checked at DELIVERY time: a message in
        # flight when the partition lands is lost, like a real cut
        if not self._link_up(msg.src, msg.dst):
            self.stats["dropped"] += 1
            return
        handler = self._handlers.get(msg.dst)
        if handler is None:
            self.stats["dropped"] += 1
            return
        self.stats["delivered"] += 1
        handler(msg)

    # ------------------------------------------------------------- topology

    def _link_up(self, src: str, dst: str) -> bool:
        if src in self._isolated or dst in self._isolated:
            return False
        if (src, dst) in self._cut:
            return False
        if self._groups is not None:
            for g in self._groups:
                if src in g:
                    return dst in g
            return False   # src in no group: fully dark
        return True

    def isolate(self, node_id: str) -> None:
        """Symmetric partition of one node."""
        self._isolated.add(node_id)
        self.engine.log(f"fault isolate {node_id}")

    def rejoin(self, node_id: str) -> None:
        self._isolated.discard(node_id)
        self.engine.log(f"fault rejoin {node_id}")

    def cut(self, a: str, b: str, symmetric: bool = True) -> None:
        """Sever a link; ``symmetric=False`` gives an asymmetric
        partition (a can reach b, b cannot reach a is expressed as
        cut(b, a, symmetric=False))."""
        self._cut.add((a, b))
        if symmetric:
            self._cut.add((b, a))
        self.engine.log(f"fault cut {a}<->{b}" if symmetric
                        else f"fault cut {a}->{b}")

    def heal(self, a: str, b: str) -> None:
        self._cut.discard((a, b))
        self._cut.discard((b, a))
        self.engine.log(f"fault heal {a}<->{b}")

    def split(self, *groups: List[str]) -> None:
        """Partition the network into the given groups (nodes absent
        from every group go fully dark)."""
        self._groups = [set(g) for g in groups]
        self.engine.log(
            "fault split " + " | ".join(",".join(sorted(g))
                                        for g in self._groups))

    def heal_all(self) -> None:
        self._groups = None
        self._cut.clear()
        self._isolated.clear()
        self.engine.log("fault heal-all")
