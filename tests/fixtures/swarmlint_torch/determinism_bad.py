"""Fixture: every determinism-seam bypass in one module (must fire)."""
import os
import random
import time
import uuid


def deadline(timeout):
    return time.time() + timeout          # bare wall clock


def wait_until(timeout):
    return time.monotonic() + timeout     # bare monotonic


def mint_id():
    return uuid.uuid4().hex               # unseamed id


def token():
    return os.urandom(16).hex()           # unseamed entropy


def make_rng():
    return random.Random()                # unseeded, not a seam default


def draw():
    return random.random()                # global unseeded RNG


class ThreadedSupervisor:
    """The rolling-update regression shape (ISSUE 8): a per-service
    worker thread pacing its monitor window off the bare wall clock —
    under the sim's virtual time the window never elapses (or elapses
    instantly), so the FSM is untestable and nondeterministic."""

    monitor = 30.0

    def run(self, slots):
        deadline = time.time() + self.monitor   # bare wall clock
        while slots and time.time() < deadline:  # and again in the loop
            slots.pop()


def load_scorer_weights(path=None):
    """The learned-scorer weight-loading shape (ISSUE 15): a missing
    artifact silently random-inits the policy — placements stop being
    reproducible AND host/device parity is gone."""
    import numpy as np
    if path is None:
        w1 = np.random.default_rng().normal(size=(6, 8))  # unseeded gen
        b1 = np.random.rand(8)                  # numpy global RNG draw
        return w1, b1
    return None


def torch_noise(n):
    """torch's global-RNG shapes: a draw with no generator=, a reseed of
    the process-wide generator, and a Generator no caller seeds."""
    import torch
    torch.manual_seed(7)                        # reseeds every caller's RNG
    g = torch.Generator()                       # never seeded
    return torch.rand(n) + torch.randint(0, 9, (n,), generator=g) \
        + torch.randperm(n)                     # two global draws
