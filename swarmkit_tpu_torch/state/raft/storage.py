"""Raft persistence: write-ahead log + snapshot files.

Reference: manager/state/raft/storage/ (EncryptedRaftLogger over etcd
wal/snap).  Layout under a state directory:

    wal.jsonl       — append-only records: hardstate / entry lines
    snapshot        — latest snapshot (index, term, payload)
    snapshot.tmp    — atomic-replace staging

Records are serde JSON lines; an ``Encoder`` seam (encode/decode bytes)
slots in at-rest encryption (reference: manager/encryption) without
touching the log logic.  On restart ``bootstrap()`` loads the snapshot,
replays the WAL, and returns (hard_state, entries, snapshot) for
RaftCore.load.  The WAL is truncated to post-snapshot entries whenever a
new snapshot is saved (KeepOldSnapshots=0 semantics).
"""

from __future__ import annotations

import base64
import hashlib
import hmac as _hmac
import json
import logging
import os
import secrets
import threading
import zlib
from typing import List, Optional, Tuple

log = logging.getLogger("raft.storage")

from .core import Entry, HardState, Snapshot


class Encoder:
    """At-rest encryption seam (reference: manager/encryption)."""

    def encode(self, data: bytes) -> bytes:
        return data

    def decode(self, data: bytes) -> bytes:
        return data


class DecryptionError(Exception):
    """Sealed state could not be authenticated: wrong key or tampering.
    Must fail closed — never be mistaken for an empty/torn log."""


class KeyEncoder(Encoder):
    """At-rest encryption of WAL records and snapshots under a data
    encryption key (reference: manager/encryption NACLSecretbox around
    the raft DEK, storage.go EncryptedRaftLogger).  Stdlib-only: a
    per-record random nonce keys an SHA256-counter XOR stream, sealed
    with an HMAC-SHA256 tag (encrypt-then-MAC); the same DEK derivation
    stand-in KeyReadWriter uses for node keys."""

    MAGIC = b"ENCR1:"

    def __init__(self, dek: bytes, allow_plaintext: bool = False,
                 fallback: "Optional[KeyEncoder]" = None):
        if not dek:
            raise ValueError("a non-empty data encryption key is required")
        self._enc_key = hashlib.sha256(b"enc" + dek).digest()
        self._mac_key = hashlib.sha256(b"mac" + dek).digest()
        # migration-only escape hatch: replaying a WAL written before
        # encryption was enabled.  Steady-state decode fails closed —
        # otherwise an attacker with state-dir write access could inject
        # unauthenticated plaintext records that replay as raft state.
        self.allow_plaintext = allow_plaintext
        # decode-only second key: a crash mid-re-key (CA rotation) can
        # leave snapshot/WAL/state-file under a mix of old and new keys;
        # the reference's RotateEncryptionKey likewise decrypts with
        # old-or-new until the snapshot barrier converges
        self.fallback = fallback

    def _stream(self, data: bytes, nonce: bytes) -> bytes:
        out = bytearray()
        counter = 0
        while len(out) < len(data):
            out.extend(hashlib.sha256(
                self._enc_key + nonce
                + counter.to_bytes(8, "big")).digest())
            counter += 1
        return bytes(a ^ b for a, b in zip(data, out[: len(data)]))

    def encode(self, data: bytes) -> bytes:
        nonce = secrets.token_bytes(16)
        body = nonce + self._stream(data, nonce)
        tag = _hmac.new(self._mac_key, body, hashlib.sha256).digest()
        return self.MAGIC + tag + body

    def decode(self, data: bytes) -> bytes:
        if not data.startswith(self.MAGIC):
            if self.allow_plaintext:
                # pre-encryption WAL migration replay, explicitly opted in
                return data
            raise DecryptionError(
                "unencrypted record in an encrypted raft log (pass "
                "allow_plaintext=True only for a one-time migration "
                "replay of a pre-encryption state dir)")
        tag, body = data[6:38], data[38:]
        want = _hmac.new(self._mac_key, body, hashlib.sha256).digest()
        if not _hmac.compare_digest(tag, want):
            if self.fallback is not None:
                return self.fallback.decode(data)
            raise DecryptionError(
                "raft log record failed authentication (wrong key or "
                "corrupted state)")
        nonce, payload = body[:16], body[16:]
        return self._stream(payload, nonce)


class RaftLogger:
    def __init__(self, state_dir: str, encoder: Optional[Encoder] = None,
                 fsync: bool = False):
        self.state_dir = state_dir
        self.encoder = encoder or Encoder()
        self.fsync = fsync
        # serializes appends vs snapshot/re-key rewrites: rotate_encoder
        # runs on reconciler/adoption threads while raft saves on its own
        self._mu = threading.RLock()
        os.makedirs(state_dir, exist_ok=True)
        self._wal_path = os.path.join(state_dir, "wal.jsonl")
        self._snap_path = os.path.join(state_dir, "snapshot")
        self._wal = None

    # ---------------------------------------------------------------- write

    def _open_wal(self, mode: str = "ab"):
        if self._wal is None:
            self._wal = open(self._wal_path, mode)
        return self._wal

    @staticmethod
    def _record_crc(record: dict) -> int:
        """CRC32 over the canonical (sorted-key) serialization of the
        record WITHOUT its crc field — integrity of the decoded content,
        so a bit flip that survives base64/JSON/decryption parsing (e.g.
        inside an entry's data payload) is still caught on replay.  The
        load path re-canonicalizes before checking, so the write path is
        free to append the crc after the canonical body."""
        body = {k: v for k, v in record.items() if k != "crc"}
        return zlib.crc32(json.dumps(body, sort_keys=True,
                                     separators=(",", ":")).encode())

    def _write_record(self, record: dict) -> None:
        # serialize the crc-less body exactly once: the checksum covers
        # these canonical bytes, and the crc field is appended textually
        # (JSON key order is irrelevant to the loader, which
        # re-canonicalizes via _record_crc before verifying)
        record.pop("crc", None)
        body = json.dumps(record, sort_keys=True, separators=(",", ":"))
        crc = zlib.crc32(body.encode())
        data = (body[:-1] + ',"crc":' + str(crc) + "}").encode()
        payload = base64.b64encode(self.encoder.encode(data))
        wal = self._open_wal()
        wal.write(payload + b"\n")
        wal.flush()
        if self.fsync:
            os.fsync(wal.fileno())

    def save(self, hard_state: Optional[HardState],
             entries: List[Entry]) -> None:
        """Persist a Ready's durable parts; called before sending/applying
        (reference: raft.go:540 saveToStorage)."""
        with self._mu:
            self._save_locked(hard_state, entries)

    def _save_locked(self, hard_state, entries) -> None:
        if hard_state is not None:
            self._write_record({
                "t": "hs", "term": hard_state.term,
                "vote": hard_state.voted_for, "commit": hard_state.commit})
        for e in entries:
            self._write_record({
                "t": "ent", "term": e.term, "index": e.index,
                "type": e.type,
                "data": base64.b64encode(e.data).decode("ascii")})

    def _write_snapshot_file(self, snapshot: Snapshot) -> None:
        tmp = self._snap_path + ".tmp"
        encoded = self.encoder.encode(snapshot.data)
        record = json.dumps({
            "index": snapshot.index, "term": snapshot.term,
            # integrity hash of the STORED (encoded) body, verified
            # before decode on load: corruption quarantines the snapshot
            # instead of restoring a damaged store.  Hashing the
            # ciphertext — never the plaintext — keeps the cleartext
            # envelope from becoming a content-confirmation oracle under
            # encryption-at-rest.
            "data_sha256": hashlib.sha256(encoded).hexdigest(),
            "peers": list(snapshot.peers),
            "peer_addrs": {k: list(v)
                           for k, v in snapshot.peer_addrs.items()},
            "api_addrs": {k: list(v)
                          for k, v in snapshot.api_addrs.items()},
            # the same encoded bytes the hash covers (the encoder is
            # nonce-randomized: encoding twice would break the pairing)
            "data": base64.b64encode(encoded).decode("ascii"),
        }, sort_keys=True).encode()
        with open(tmp, "wb") as f:
            f.write(record)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)

    def _rewrite_wal(self, hs: Optional[HardState], entries: List[Entry],
                     keep_entries_from: int) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        wal_tmp = self._wal_path + ".tmp"
        with open(wal_tmp, "wb") as f:
            self._wal = f
            if hs is not None:
                self._write_record({"t": "hs", "term": hs.term,
                                    "vote": hs.voted_for,
                                    "commit": hs.commit})
            for e in entries:
                if e.index > keep_entries_from:
                    self._write_record({
                        "t": "ent", "term": e.term, "index": e.index,
                        "type": e.type,
                        "data": base64.b64encode(e.data).decode("ascii")})
            self._wal = None
        os.replace(wal_tmp, self._wal_path)

    def save_snapshot(self, snapshot: Snapshot,
                      keep_entries_from: int) -> None:
        """Atomically persist a snapshot and truncate the WAL to entries
        after ``keep_entries_from`` (reference: storage.go:198)."""
        with self._mu:
            self._write_snapshot_file(snapshot)
            # rewrite the WAL without pre-snapshot entries
            hs, entries, _ = self._load_wal()
            self._rewrite_wal(hs, entries, keep_entries_from)

    def rewrite(self, hard_state: Optional[HardState],
                entries: List[Entry], keep_entries_from: int = 0) -> None:
        """Replace the on-disk WAL with exactly these records (used by
        force-new-cluster to drop a stale uncommitted tail that the
        snapshot rewrite would otherwise preserve)."""
        with self._mu:
            self._rewrite_wal(hard_state, entries, keep_entries_from)

    def rotate_encoder(self, new_encoder: Encoder) -> None:
        """Re-encrypt all persisted raft state under a new key: decode
        with the old encoder, swap, rewrite snapshot + WAL (reference:
        storage.go:175 RotateEncryptionKey + its snapshot barrier)."""
        with self._mu:
            hs, entries, _ = self._load_wal()   # decoded with the OLD key
            snapshot = self.load_snapshot()
            self.encoder = new_encoder
            if snapshot is not None:
                self._write_snapshot_file(snapshot)
            self._rewrite_wal(hs, entries, keep_entries_from=0)

    # ----------------------------------------------------------------- read

    def _load_wal(self) -> Tuple[Optional[HardState], List[Entry], int]:
        hs: Optional[HardState] = None
        entries: List[Entry] = []
        if not os.path.exists(self._wal_path):
            return hs, entries, 0
        count = 0
        with open(self._wal_path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    data = self.encoder.decode(base64.b64decode(line))
                    rec = json.loads(data)
                except DecryptionError:
                    raise   # wrong key must not look like an empty log
                except Exception:
                    break  # torn tail record: stop replay here
                crc = rec.get("crc")
                if crc is not None and crc != self._record_crc(rec):
                    # corrupt record (bit flip that survived parsing):
                    # everything from here on is untrustworthy — stop
                    # replay exactly like a torn tail.  Records without
                    # a crc are legacy (pre-CRC WALs) and replay as-is.
                    log.error("WAL record %d failed CRC32; truncating "
                              "replay here", count + 1)
                    break
                count += 1
                if rec["t"] == "hs":
                    hs = HardState(term=rec["term"], voted_for=rec["vote"],
                                   commit=rec["commit"])
                elif rec["t"] == "ent":
                    e = Entry(term=rec["term"], index=rec["index"],
                              type=rec.get("type", 0),
                              data=base64.b64decode(rec["data"]))
                    # later records override earlier ones (truncation)
                    while entries and entries[-1].index >= e.index:
                        entries.pop()
                    entries.append(e)
        return hs, entries, count

    def read_wal(self):
        """Public read of the WAL: (hard_state | None, entries) — used by
        rafttool and diagnostics."""
        hs, entries, _ = self._load_wal()
        return hs, entries

    def _quarantine_snapshot(self, reason: str) -> None:
        """Move the corrupt snapshot aside (``snapshot.corrupt``) so
        bootstrap falls back to WAL-only replay instead of restoring a
        damaged store — and the evidence survives for forensics."""
        corrupt = self._snap_path + ".corrupt"
        try:
            os.replace(self._snap_path, corrupt)
            log.error("snapshot quarantined to %s (%s); bootstrap will "
                      "replay the WAL only", corrupt, reason)
        except OSError:
            log.exception("quarantining corrupt snapshot failed")

    def load_snapshot(self) -> Optional[Snapshot]:
        if not os.path.exists(self._snap_path):
            return None
        # transient I/O errors (EIO, permissions) must NOT look like
        # corruption: quarantining a healthy snapshot on a flaky read
        # would permanently degrade bootstrap to the post-compaction WAL
        # tail — let OSError propagate to the caller instead
        with open(self._snap_path, "rb") as f:
            raw = f.read()
        try:
            rec = json.loads(raw)
            body = base64.b64decode(rec["data"])
        except Exception:
            self._quarantine_snapshot("unparseable")
            return None
        want = rec.get("data_sha256")
        if want is not None and \
                hashlib.sha256(body).hexdigest() != want:
            # stored-body hash mismatch, checked BEFORE decryption
            # (absent hash = legacy snapshot)
            self._quarantine_snapshot("body hash mismatch")
            return None
        try:
            return Snapshot(
                index=rec["index"], term=rec["term"],
                peers=list(rec.get("peers", [])),
                peer_addrs={k: tuple(v) for k, v in
                            rec.get("peer_addrs", {}).items()},
                api_addrs={k: tuple(v) for k, v in
                           rec.get("api_addrs", {}).items()},
                data=self.encoder.decode(body))
        except DecryptionError:
            raise   # wrong key/tampering must not read as "no snapshot"
        except Exception:
            self._quarantine_snapshot("unparseable")
            return None

    def bootstrap(self) -> Tuple[HardState, List[Entry],
                                 Optional[Snapshot]]:
        """reference: storage.go:51 BootstrapFromDisk."""
        snapshot = self.load_snapshot()
        hs, entries, _ = self._load_wal()
        if snapshot is not None:
            entries = [e for e in entries if e.index > snapshot.index]
        return hs or HardState(), entries, snapshot

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None
