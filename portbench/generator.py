"""The one traffic generator: a cluster and its steps, as plain data,
from a configuration file, a traffic file and ``--seed``.

A configuration (``configs/<config>.json``) holds the nodes (a count and
how each is made: CPUs, memory, labels and platform by index) and the
services' shapes.  A traffic mix (``traffic/<mix>.json``) holds what runs
on it: the tasks already running at the start (``base``: ``tasks``
tasks dealt round the listed services, each of the shape of its name,
and round the nodes in index order), the steps of set-up
(``warmup_steps``) and what one step does (``step``).  A step is
a closed loop's turn: its store writes, then the preassigned pass and one
tick.  A step may

- ``replace``: remove the previous step's services with their tasks and
  create new services of the listed shapes, each with ``tasks`` PENDING
  tasks of which ``preassigned_share`` come preassigned to a node drawn
  from the seed, as a global service's do (``build_cluster`` /
  ``headline_cluster`` of ``swarmkit_tpu_torch/workload.py``);
- ``arrivals``: Poisson(``lam``) PENDING tasks, at least ``min``, of one
  service, rotating over ``rotate`` (``churn_script``);
- ``report``: the tasks the previous step created report RUNNING, as
  their nodes' agents would once they started them (placed tasks only:
  the harness leaves a task that is not ASSIGNED as it is);
- ``exits``: Poisson(``lam``) of the oldest RUNNING tasks end: the base
  first, then the reported tasks in the order they reported
  (``SteadyStateChurn.exit_some``, which stops at the end of the base).

Everything is drawn from one ``random.Random(seed)`` in a fixed order, so
a seed gives the same cluster and steps, and every seed the same amount
of work in the ``replace`` mixes.  Nothing here imports the program: the
harness turns this data into the program's objects, and the plain
reference reads it as it is.
"""

from __future__ import annotations

import math
import random
from collections import deque
from typing import Dict, List


def poisson(rng: random.Random, lam: float) -> int:
    """Knuth's inversion sampler (``swarmkit_tpu_torch/utils/sampling.py``
    ``poisson``, copied)."""
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


def _fmt(template: str, i: int) -> str:
    return template.format(i=i)


def _pick(rule: dict, i: int):
    """A value that depends on the node index: ``{"cycle": [...]}`` takes
    the entry ``i % len``, anything else is the value itself."""
    if isinstance(rule, dict) and "cycle" in rule:
        return rule["cycle"][i % len(rule["cycle"])]
    return rule


def make_nodes(cfg: dict, rng: random.Random) -> List[dict]:
    """The configuration's nodes in the cluster's order."""
    spec = cfg["nodes"]
    ids = spec.get("ids", "random")
    out = []
    for i in range(spec["count"]):
        nid = (f"{rng.getrandbits(96):024x}" if ids == "random"
               else _fmt(ids, i))
        labels = {k: _fmt(_pick(v, i), i) if isinstance(_pick(v, i), str)
                  else _pick(v, i) for k, v in spec.get("labels", {}).items()}
        out.append(dict(
            id=nid, hostname=_fmt(spec["hostname"], i), labels=labels,
            os=spec.get("os", "linux"), arch=spec.get("arch", "amd64"),
            cpu=int(round(spec["cpus"] * 1e9)),
            mem=int(spec["memory_gib"] * (1 << 30)), ready=True))
    return out


def shapes_of(cfg: dict) -> Dict[str, dict]:
    """Service shape name -> reservations (nano-CPUs, bytes), constraints,
    platforms and spread descriptors."""
    out = {}
    for name, s in cfg["shapes"].items():
        out[name] = dict(
            cpu=int(round(s["cpus"] * 1e9)),
            mem=int(s["memory_mib"]) << 20,
            constraints=list(s.get("constraints", [])),
            platforms=[dict(p) for p in s.get("platforms", [])],
            spread=list(s.get("spread", [])),
            strategy=s.get("strategy", "spread"))
    return out


class Traffic:
    """A cluster and an endless sequence of steps drawn from ``seed``.

    ``nodes``, ``shapes``, ``services`` (id -> shape name at the start)
    and ``base`` ((task id, service id, node index), RUNNING) describe
    the cluster before the first step; :meth:`next_step` draws one step:
    a dict with ``running`` (task ids reported RUNNING), ``remove``
    (service ids), ``services`` (new id -> shape), ``create`` ((task id,
    service id, preassigned node index or -1)) and ``exits`` (task ids),
    written to the store in that order."""

    def __init__(self, cfg: dict, mix: dict, seed: int):
        self.rng = rng = random.Random(seed)
        self.mix = mix
        self.nodes = make_nodes(cfg, rng)
        self.shapes = shapes_of(cfg)
        self.services: Dict[str, str] = {}
        self.base: List[tuple] = []
        self.live: deque = deque()
        self.steps = 0
        self._current: List[str] = []
        self._created: List[str] = []
        self._seq: Dict[str, int] = {}
        base = mix.get("base")
        if base:
            for sid in base["services"]:      # each its own shape
                self.services[sid] = sid
            n = len(self.nodes)
            for k in range(base["tasks"]):
                sid = base["services"][k % len(base["services"])]
                tid = f"{sid}-base{k:06d}"
                self.base.append((tid, sid, k % n))
                self.live.append(tid)

    def warmup_steps(self) -> int:
        return int(self.mix.get("warmup_steps", 0))

    def next_step(self) -> dict:
        rng = self.rng
        step = self.mix["step"]
        out = dict(running=[], remove=[], services={}, create=[], exits=[])
        w = self.steps
        self.steps += 1
        if step.get("report"):
            out["running"] = self._created
            if step.get("exits"):
                self.live.extend(self._created)
        replace = step.get("replace")
        if replace:
            out["remove"] = self._current
            self._current = []
            n = len(self.nodes)
            for r in replace:
                sid = f"s{rng.getrandbits(64):016x}"
                out["services"][sid] = r["shape"]
                self._current.append(sid)
                count = int(r["tasks"])
                n_pre = int(count * float(r.get("preassigned_share", 0.0)))
                for s in range(count):
                    pre = rng.randrange(n) if s < n_pre else -1
                    out["create"].append((f"{sid}-t{s:06d}", sid, pre))
            for sid in out["remove"]:
                self.services.pop(sid, None)
            self.services.update(out["services"])
        arrivals = step.get("arrivals")
        if arrivals:
            rotate = arrivals["rotate"]
            sid = rotate[w % len(rotate)]
            count = max(int(arrivals.get("min", 0)),
                        poisson(rng, float(arrivals["lam"])))
            seq = self._seq.get(sid, 0)
            for k in range(count):
                out["create"].append((f"{sid}-a{seq + k:06d}", sid, -1))
            self._seq[sid] = seq + count
        exits = step.get("exits")
        if exits:
            count = min(poisson(rng, float(exits["lam"])), len(self.live))
            out["exits"] = [self.live.popleft() for _ in range(count)]
        self._created = [tid for tid, _, _ in out["create"]]
        return out
