"""Fixture: the corrected twin — everything flows through the seams."""
import random
import time

from swarmkit_tpu_torch.models.types import now
from swarmkit_tpu_torch.utils import identity


def deadline(timeout):
    return now() + timeout                # the time seam


def mint_id():
    return identity.new_id()              # the id seam


def token():
    return identity.new_secret()          # the entropy seam


class Worker:
    def __init__(self, rng=None, clock=None):
        # the sanctioned constructor-default idiom for injected seams
        self._rng = rng or random.Random()
        self._clock = clock or time.monotonic   # reference, not a call

    def draw(self):
        return self._rng.random()

    def measure(self):
        return time.perf_counter()        # duration measurement: allowed


class DrivenSupervisor:
    """The corrected twin of the threaded-supervisor shape: deadlines
    read the ``now()`` seam and the FSM is pumped by ``drive()`` —
    production wraps it in a thread, the simulator calls it directly
    under virtual time (orchestrator/update.py's design)."""

    monitor = 30.0

    def begin(self, slots):
        self._slots = list(slots)
        self._deadline = now() + self.monitor   # the time seam

    def drive(self):
        if self._slots and now() < self._deadline:
            self._slots.pop()


def load_scorer_weights(path):
    """Learned-scorer weights load ONLY from the checked-in artifact —
    deterministic, and a missing file is an error, not a random init."""
    import json

    with open(path) as f:
        return json.load(f)


def synthesize_trace(seed):
    # offline tooling may draw noise — through an explicitly seeded
    # generator, never the global RNG
    import numpy as np

    return np.random.default_rng(seed).normal(size=8)


def torch_noise(n, seed):
    # torch noise through a generator the caller seeds, never the global
    # one
    import torch
    g = torch.Generator()
    g.manual_seed(seed)
    other = torch.Generator().manual_seed(seed + 1)
    return torch.rand(n, generator=g) + torch.randperm(n, generator=other)
