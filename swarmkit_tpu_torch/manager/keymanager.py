"""Key manager: rotates cluster-wide dataplane encryption keys.

Reference: manager/keymanager/keymanager.go (:22-45 config, :124 rotateKey,
:173 Run).

Maintains one key per subsystem (gossip/IPSec-equivalents) in the cluster
object's ``network_bootstrap_keys``, keeping the last two keys per
subsystem (current + previous, so agents can roll over), stamped with a
lamport clock; rotates on a configurable period.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass, field
from typing import List, Optional

from ..models.objects import Cluster
from ..models.types import EncryptionKey
from ..state.store import ByName, MemoryStore

log = logging.getLogger("keymanager")

DEFAULT_KEY_LEN = 16
DEFAULT_ROTATION_INTERVAL = 12 * 3600.0   # reference: keymanager.go:30
SUBSYSTEM_GOSSIP = "networking:gossip"
SUBSYSTEM_IPSEC = "networking:ipsec"


@dataclass
class Config:
    cluster_name: str = "default"
    keylen: int = DEFAULT_KEY_LEN
    rotation_interval: float = DEFAULT_ROTATION_INTERVAL
    subsystems: List[str] = field(
        default_factory=lambda: [SUBSYSTEM_GOSSIP, SUBSYSTEM_IPSEC])


class KeyManager:
    def __init__(self, store: MemoryStore, config: Optional[Config] = None):
        self.store = store
        self.config = config or Config()
        self.keys: List[EncryptionKey] = []
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _new_key(self, subsystem: str, lamport: int) -> EncryptionKey:
        # overlay encryption keys are cryptographic material: they must
        # come from the OS CSPRNG, never a seeded/simulated source
        # swarmlint: disable=determinism-seam
        key = os.urandom(self.config.keylen)
        return EncryptionKey(subsystem=subsystem, algorithm=0,
                             key=key, lamport_time=lamport)

    def rotate_now(self) -> None:
        """One rotation pass (reference: rotateKey :124)."""
        def cb(tx):
            clusters = tx.find(Cluster, ByName(self.config.cluster_name))
            if not clusters:
                return
            cluster = clusters[0].copy()
            clock = cluster.encryption_key_lamport_clock + 1
            keys = list(cluster.network_bootstrap_keys)
            for subsys in self.config.subsystems:
                subsys_keys = [k for k in keys if k.subsystem == subsys]
                # keep only the newest old key + the fresh one
                subsys_keys.sort(key=lambda k: -k.lamport_time)
                keep = subsys_keys[:1]
                keys = [k for k in keys if k.subsystem != subsys]
                keys.extend(keep)
                keys.append(self._new_key(subsys, clock))
            cluster.network_bootstrap_keys = keys
            cluster.encryption_key_lamport_clock = clock
            tx.update(cluster)
            self.keys = keys

        try:
            self.store.update(cb)
        except Exception:
            log.exception("key rotation failed")

    def run(self) -> None:
        try:
            # ensure keys exist at startup
            def need_keys(tx):
                clusters = tx.find(Cluster, ByName(self.config.cluster_name))
                return bool(clusters) and \
                    not clusters[0].network_bootstrap_keys

            if self.store.view(need_keys):
                self.rotate_now()
            while not self._stop.wait(
                    timeout=self.config.rotation_interval):
                self.rotate_now()
        finally:
            self._done.set()

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name="keymanager",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._done.wait(timeout=5)
