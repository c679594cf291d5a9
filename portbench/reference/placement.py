"""The plain reference of the scheduler's placements: NumPy and the
standard library only.

It imports nothing of the program under test.  It is handed the same
cluster and traffic the program is handed, as plain data, and works out
again, step by step, where swarmkit's scheduler puts each task:

- A preassigned task (a global service's) is confirmed on its node when
  the node is ready, meets the task's reservations, constraints and
  platforms, and still has room after the earlier tasks of its batch
  (reference ``scheduler.go:646 taskFitNode``).  The preassigned pass runs
  before the tick.
- The tick places each pending group (one service) in queue order.  A
  node is feasible when it is ready, meets the reservations, every
  constraint (``==`` / ``!=``, values compared case-insensitively) and one
  of the platforms.  Its capacity is how many more tasks its free CPU and
  memory hold.
- Spread: the group's tasks go level by level down the tree of its spread
  preferences (reference ``scheduler.go:772``).  At each level the
  branches are the descriptor's values in the order the nodes first show
  them; each branch's load is the service's tasks on every node of the
  branch, feasible or not, and its room the capacity of its feasible
  nodes.  A unit goes to the branch with the lowest load, ties to the
  earlier branch, until the group is placed or no branch has room.
  Inside a leaf a unit goes to the feasible node with the fewest tasks of
  the service, ties to the node with the fewest tasks in all, then to the
  earlier node in the cluster's order (``scheduler.go:708 nodeLess``, the
  order the port documents for its ties).
- Tasks that find no room stay queued and their group is tried again at
  the next tick, before the groups that arrive after it.

The placements of a step are returned as node indices (-1: not placed),
in the order the step created its tasks.  Recent task failures, generic
resources, host ports, max-replicas, volumes, quotas, gangs, priorities
and non-spread strategies are outside this reference; it raises on a
shape that asks for one, and the cells that use it ask for none.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

_LABEL = "node.labels."


def parse_constraint(expr: str):
    """(key, op, value) of ``key==value`` or ``key!=value``."""
    for op in ("==", "!="):
        if op in expr:
            key, value = expr.split(op, 1)
            return key.strip(), op, value.strip()
    raise ValueError(f"unsupported constraint {expr!r}")


def node_value(node: dict, key: str) -> str:
    """A node's value for a constraint or spread key."""
    k = key.lower()
    if k == "node.id":
        return node["id"]
    if k == "node.hostname":
        return node["hostname"]
    if k == "node.platform.os":
        return node["os"]
    if k == "node.platform.arch":
        return node["arch"]
    if k.startswith(_LABEL) and len(key) > len(_LABEL):
        return node["labels"].get(key[len(_LABEL):], "")
    raise ValueError(f"unsupported key {key!r}")


def _arch(a: str) -> str:
    return {"x86_64": "amd64", "aarch64": "arm64"}.get(a, a)


def fill(level: np.ndarray, room: np.ndarray, rank: np.ndarray,
         k: int) -> np.ndarray:
    """Place ``k`` units one at a time, each on the element whose next
    unit sits lowest: element i's j-th unit sits at ``level[i] + j``, at
    most ``room[i]`` units, equal heights going to the lower ``rank``.
    Returns the units per element (fewer than ``k`` in all when the room
    runs out)."""
    level = level.astype(np.int64)
    room = np.maximum(room.astype(np.int64), 0)
    k = int(min(k, int(room.sum())))
    if k <= 0:
        return np.zeros(level.shape[0], np.int64)

    def units_below(h):
        return int(np.minimum(np.maximum(h - level, 0), room).sum())

    lo = int(level.min())                 # no unit sits below lo
    hi = int((level + room).max())        # every unit sits below hi
    while lo < hi:                        # least h with k units below h
        mid = (lo + hi) // 2
        if units_below(mid) >= k:
            hi = mid
        else:
            lo = mid + 1
    top = lo - 1                          # the height the last units sit at
    x = np.minimum(np.maximum(top - level, 0), room)
    rest = k - int(x.sum())
    if rest > 0:
        at_top = np.nonzero((level <= top) & (x < room))[0]
        x[at_top[np.argsort(rank[at_top], kind="stable")[:rest]]] += 1
    return x


class Reference:
    """The cluster's state as the scheduler's mirror would hold it, and
    the placements each step makes.

    ``nodes``: dicts with ``id``, ``hostname``, ``labels``, ``os``,
    ``arch``, ``cpu`` (nano-CPUs), ``mem`` (bytes), ``ready``, in the
    cluster's order.  ``shapes``: name -> dict with ``cpu``, ``mem``,
    ``constraints`` (strings), ``platforms`` (dicts of ``os``, ``arch``),
    ``spread`` (descriptors, top level first).  ``services``: service id
    -> shape name, extended by the steps.  ``base``: (task id, service id,
    node index) of tasks already running."""

    def __init__(self, nodes: Sequence[dict], shapes: Dict[str, dict],
                 services: Dict[str, str],
                 base: Sequence[tuple] = ()):
        self.nodes = list(nodes)
        self.shapes = shapes
        self.services = dict(services)
        n = len(self.nodes)
        self.n = n
        self.ready = np.array([bool(x["ready"]) for x in self.nodes], bool)
        self.cpu = np.array([x["cpu"] for x in self.nodes], np.int64)
        self.mem = np.array([x["mem"] for x in self.nodes], np.int64)
        self.total = np.zeros(n, np.int64)
        self.svc: Dict[str, np.ndarray] = {}
        #: task id -> (service id, node index or -1, preassigned node or -1)
        self.tasks: Dict[str, tuple] = {}
        #: pending groups in queue order: service id -> task ids
        self.queue: Dict[str, List[str]] = {}
        #: preassigned tasks not yet confirmed, in arrival order
        self.pre_pending: Dict[str, None] = {}
        self._masks: Dict[str, np.ndarray] = {}
        self._values: Dict[str, np.ndarray] = {}
        for tid, sid, i in base:
            self.tasks[tid] = (sid, -1, i)
            self._place(tid, i)

    # ------------------------------------------------------------- state

    def _counts(self, sid: str) -> np.ndarray:
        col = self.svc.get(sid)
        if col is None:
            col = self.svc[sid] = np.zeros(self.n, np.int64)
        return col

    def _shape(self, sid: str) -> dict:
        shape = self.shapes[self.services[sid]]
        if shape.get("strategy", "spread") != "spread":
            raise NotImplementedError("only the spread strategy")
        return shape

    def _place(self, tid: str, i: int) -> None:
        sid, _, pre = self.tasks[tid]
        shape = self._shape(sid)
        self.tasks[tid] = (sid, i, pre)
        self._counts(sid)[i] += 1
        self.total[i] += 1
        self.cpu[i] -= shape["cpu"]
        self.mem[i] -= shape["mem"]

    def _forget(self, tid: str) -> None:
        entry = self.tasks.pop(tid, None)
        if entry is None:
            return
        sid, i, _ = entry
        if i >= 0:
            shape = self._shape(sid)
            self.svc[sid][i] -= 1
            self.total[i] -= 1
            self.cpu[i] += shape["cpu"]
            self.mem[i] += shape["mem"]
            return
        self.pre_pending.pop(tid, None)
        group = self.queue.get(sid)
        if group is not None and tid in group:
            group.remove(tid)
            if not group:
                del self.queue[sid]

    # ------------------------------------------------------- feasibility

    def constraint_mask(self, shape_name: str) -> np.ndarray:
        """Nodes that meet the shape's constraints and platforms (they
        read only what a node is, so the mask is kept)."""
        mask = self._masks.get(shape_name)
        if mask is not None:
            return mask
        shape = self.shapes[shape_name]
        mask = np.ones(self.n, bool)
        for expr in shape.get("constraints", ()):
            key, op, want = parse_constraint(expr)
            eq = np.array([node_value(x, key).lower() == want.lower()
                           for x in self.nodes], bool)
            mask &= eq if op == "==" else ~eq
        plats = shape.get("platforms", ())
        if plats:
            ok = np.zeros(self.n, bool)
            for p in plats:
                want_os, want_arch = p.get("os", ""), _arch(
                    p.get("arch", ""))
                ok |= np.array([(not want_os or x["os"] == want_os)
                                and (not want_arch
                                     or _arch(x["arch"]) == want_arch)
                                for x in self.nodes], bool)
            mask &= ok
        self._masks[shape_name] = mask
        return mask

    def room(self, sid: str, k: int) -> np.ndarray:
        """Tasks of ``sid`` each node can take now (0 where infeasible),
        at most ``k``."""
        shape = self._shape(sid)
        room = np.full(self.n, k, np.int64)
        ok = self.ready & self.constraint_mask(self.services[sid])
        for avail, want in ((self.cpu, shape["cpu"]),
                            (self.mem, shape["mem"])):
            if want > 0:
                ok &= avail >= want
                room = np.minimum(room, avail // want)
        return np.where(ok, np.maximum(room, 0), 0)

    def _value_ids(self, descriptor: str) -> np.ndarray:
        """Each node's value of ``descriptor``, numbered in the order the
        nodes first show them (a node property: worked out once)."""
        ids = self._values.get(descriptor)
        if ids is None:
            seen: Dict[str, int] = {}
            ids = self._values[descriptor] = np.array(
                [seen.setdefault(node_value(x, descriptor), len(seen))
                 for x in self.nodes], np.int64)
        return ids

    # ------------------------------------------------------------ placing

    def _spread(self, sid: str, idx: np.ndarray, descriptors: List[str],
                room: np.ndarray, k: int) -> np.ndarray:
        """Units per node of ``idx`` (cluster order) for ``k`` tasks."""
        counts = self.svc[sid]
        if not descriptors:
            rank = np.lexsort((idx, self.total[idx]))
            order = np.empty(len(idx), np.int64)
            order[rank] = np.arange(len(idx))
            return fill(counts[idx], room[idx], order, k)
        # the values among idx, still in first-appearance order
        ids = self._value_ids(descriptors[0])[idx]
        present = np.unique(ids)
        branch = np.searchsorted(present, ids)
        m = len(present)
        load = np.bincount(branch, weights=counts[idx], minlength=m)
        cap = np.bincount(branch, weights=room[idx], minlength=m)
        alloc = fill(load.astype(np.int64), cap.astype(np.int64),
                     np.arange(m), k)
        out = np.zeros(len(idx), np.int64)
        for b in range(m):
            if alloc[b]:
                sel = np.nonzero(branch == b)[0]
                out[sel] = self._spread(sid, idx[sel], descriptors[1:],
                                        room, int(alloc[b]))
        return out

    def _tick_group(self, sid: str, tids: List[str]) -> List[str]:
        """Place a group; returns the task ids left unplaced."""
        self._counts(sid)
        room = self.room(sid, len(tids))
        x = self._spread(sid, np.arange(self.n),
                         list(self._shape(sid).get("spread", ())), room,
                         len(tids))
        nodes = np.repeat(np.arange(self.n), x)
        for tid, i in zip(tids, nodes.tolist()):
            self._place(tid, i)
        return tids[len(nodes):]

    def _preassigned_pass(self) -> None:
        batches: Dict[str, List[str]] = {}
        for tid in self.pre_pending:
            batches.setdefault(self.tasks[tid][0], []).append(tid)
        for sid, tids in batches.items():
            room = self.room(sid, len(tids))
            used = np.zeros(self.n, np.int64)
            for tid in tids:
                i = self.tasks[tid][2]
                if used[i] < room[i]:
                    used[i] += 1
                    self._place(tid, i)
                    del self.pre_pending[tid]

    def step(self, remove: Sequence[str] = (),
             create: Sequence[tuple] = (), exits: Sequence[str] = (),
             services: Optional[Dict[str, str]] = None) -> np.ndarray:
        """One step: the services in ``remove`` go with their tasks (a
        task reported RUNNING stays where it was placed, so reports change
        nothing here); the
        services in ``services`` (id -> shape) and the tasks of ``create``
        ((task id, service id, preassigned node index or -1)) arrive; the
        tasks of ``exits`` end; then the preassigned pass and one tick.
        Returns the node index of each created task (-1: not placed)."""
        if remove:
            gone = set(remove)
            for tid in [t for t, e in self.tasks.items() if e[0] in gone]:
                self._forget(tid)
            for sid in gone:
                self.svc.pop(sid, None)
                self.services.pop(sid, None)
        self.services.update(services or {})
        for tid, sid, pre in create:
            self.tasks[tid] = (sid, -1, pre)
            if pre >= 0:
                self.pre_pending[tid] = None
            else:
                self.queue.setdefault(sid, []).append(tid)
        for tid in exits:
            self._forget(tid)
        if self.pre_pending:
            self._preassigned_pass()
        queue, self.queue = self.queue, {}
        for sid, tids in queue.items():
            left = self._tick_group(sid, tids)
            if left:
                self.queue[sid] = left
        return np.array([self.tasks[tid][1] if tid in self.tasks else -1
                         for tid, _, _ in create], np.int64)
