"""Offline raft state inspection and repair for manager state dirs.

Reference: swarmd/cmd/swarm-rafttool (dump.go decrypt/dump commands,
main.go downgrade-key, renewcert.go) — offline WAL/snapshot decrypt &
dump, key downgrade, and certificate renewal for debugging and disaster
recovery.

Usage (module or CLI):
    python -m swarmkit_tpu_torch.rafttool dump-wal <state-dir> [unlock-key]
    python -m swarmkit_tpu_torch.rafttool dump-snapshot <state-dir> [unlock-key]
    python -m swarmkit_tpu_torch.rafttool dump-object <state-dir> <collection>
    python -m swarmkit_tpu_torch.rafttool decrypt <state-dir> <out-dir> [key]
    python -m swarmkit_tpu_torch.rafttool downgrade-key <state-dir> <unlock-key>
    python -m swarmkit_tpu_torch.rafttool renew-certs <state-dir> [unlock-key]

``state-dir`` may be a swarmd manager state directory (encrypted WAL
under the persisted CA key, optionally autolock-sealed — pass the
operator's unlock key) or a bare raft logger directory (plaintext).
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

from .state import serde
from .state.raft.storage import KeyEncoder, RaftLogger


def _open_logger(state_dir: str, unlock_key: str = "") -> RaftLogger:
    """A decoding RaftLogger for either a swarmd manager state dir
    (encrypted under the persisted CA key) or a bare logger dir."""
    state = _load_state(state_dir, unlock_key)
    if state is not None:
        # prev_ca_key present = a crash interrupted a CA-rotation re-key:
        # some records may still be sealed under the old key, exactly the
        # disaster this tool exists for (mirrors swarmd's own loader)
        prev = state.get("prev_ca_key")
        return RaftLogger(
            os.path.join(state_dir, "raft"),
            encoder=KeyEncoder(state["ca_key"],
                               fallback=KeyEncoder(prev) if prev
                               else None))
    return RaftLogger(state_dir)


def _load_state(state_dir: str, unlock_key: str = ""):
    """The swarmd manager-state record, or None for bare logger dirs
    (raises on a sealed state without the right unlock key)."""
    if not os.path.exists(os.path.join(state_dir, "manager-state.json")):
        return None
    from .swarmd import Swarmd
    probe = Swarmd.__new__(Swarmd)
    probe.state_dir = state_dir
    probe.unlock_key = unlock_key
    probe.raft_id = ""
    state = probe._load_manager_state()
    if state is not None:
        state["raft_id"] = probe.raft_id   # loader restored it
    return state


def dump_wal(state_dir: str, unlock_key: str = "") -> List[dict]:
    """Decoded WAL records: hard-state changes and entries with their
    store actions."""
    logger = _open_logger(state_dir, unlock_key)
    hs, entries = logger.read_wal()
    out: List[dict] = []
    if hs is not None:
        out.append({"type": "hardstate", "term": hs.term,
                    "vote": hs.voted_for, "commit": hs.commit})
    for e in entries:
        rec = {"type": "entry", "index": e.index, "term": e.term}
        if e.type != 0:
            rec["entry_type"] = "noop"
        elif e.data:
            try:
                # the shared entry grammar: binary columnar task blocks
                # (serde.BLOCK_ENTRY_MAGIC) and JSON change lists both
                # decode through the same seam the apply paths use
                actions = serde.entry_to_actions(e.data)
                rec["actions"] = [
                    {"action": "task_block",
                     "collection": "tasks",
                     "items": len(a.ids),
                     "base_version": a.base_version}
                    if a.action == "task_block" else
                    {"action": a.action, "collection": a.obj.collection,
                     "id": a.obj.id}
                    for a in actions]
            except Exception:
                rec["actions"] = "<undecodable>"
        out.append(rec)
    return out


def dump_snapshot(state_dir: str, unlock_key: str = "") -> Optional[dict]:
    """Snapshot summary: index/term + object counts per collection."""
    logger = _open_logger(state_dir, unlock_key)
    snap = logger.load_snapshot()
    if snap is None:
        return None
    summary = {"index": snap.index, "term": snap.term}
    if snap.data:
        payload = json.loads(snap.data)
        summary["store_version"] = payload.get("version")
        summary["objects"] = {
            coll: len(objs)
            for coll, objs in payload.get("tables", {}).items() if objs}
    return summary


def dump_objects(state_dir: str, collection: str,
                 unlock_key: str = "") -> List[dict]:
    """Full decoded objects of one collection from the snapshot."""
    logger = _open_logger(state_dir, unlock_key)
    snap = logger.load_snapshot()
    if snap is None or not snap.data:
        return []
    payload = json.loads(snap.data)
    return payload.get("tables", {}).get(collection, [])


def decrypt(state_dir: str, out_dir: str, unlock_key: str = "") -> None:
    """Write a PLAINTEXT copy of the WAL + snapshot to ``out_dir``
    (reference: rafttool decrypt) — for inspection with external tools.
    The output holds the cluster's full state unencrypted; handle it like
    the key material itself."""
    src = _open_logger(state_dir, unlock_key)
    hs, entries = src.read_wal()
    snap = src.load_snapshot()
    os.makedirs(out_dir, exist_ok=True)
    dst = RaftLogger(out_dir)   # no encoder: plaintext
    if snap is not None:
        dst.save_snapshot(snap, snap.index)
    dst.rewrite(hs, entries)


def downgrade_key(state_dir: str, unlock_key: str) -> None:
    """Unseal an autolocked manager state file so the daemon can start
    without the unlock key (reference: rafttool downgrade-key)."""
    state = _load_state(state_dir, unlock_key)
    if state is None:
        raise SystemExit(f"{state_dir} has no manager state file")
    payload = json.dumps({
        "raft_id": state.get("raft_id", ""),
        "ca_key": state["ca_key"].hex(),
        "ca_cert": state["ca_cert"].hex(),
        "prev_ca_key": state["prev_ca_key"].hex()
        if state.get("prev_ca_key") else "",
        "raft_port": state["raft_port"],
        "api_port": state.get("api_port", 0),
    }).encode()
    path = os.path.join(state_dir, "manager-state.json")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def renew_certs(state_dir: str, unlock_key: str = "") -> str:
    """Offline node-certificate renewal from the locally persisted CA —
    disaster recovery for a manager whose certs expired while the cluster
    was down (reference: rafttool renewcert.go)."""
    from .security import RootCA
    from .security.ca import KeyReadWriter

    state = _load_state(state_dir, unlock_key)
    if state is None:
        raise SystemExit(f"{state_dir} has no manager state file")
    ca = RootCA(state["ca_key"], state["ca_cert"])
    rw = KeyReadWriter(os.path.join(state_dir, "certificates", "node.key"))
    try:
        cert, _ = rw.read()
    except FileNotFoundError:
        raise SystemExit(
            f"{state_dir} has no node certificate to renew (the daemon "
            "re-issues one on next start from its join token)")
    fresh = ca.issue(cert.node_id, cert.role)
    rw.write(fresh, b"")
    return cert.node_id


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 2
    cmd, state_dir = argv[0], argv[1]
    if cmd == "dump-wal":
        for rec in dump_wal(state_dir, *(argv[2:3])):
            print(json.dumps(rec, sort_keys=True))
        return 0
    if cmd == "dump-snapshot":
        print(json.dumps(dump_snapshot(state_dir, *(argv[2:3])),
                         sort_keys=True, indent=2))
        return 0
    if cmd == "dump-object":
        if len(argv) < 3:
            print("usage: dump-object <state-dir> <collection>")
            return 2
        for obj in dump_objects(state_dir, argv[2], *(argv[3:4])):
            print(json.dumps(obj, sort_keys=True))
        return 0
    if cmd == "decrypt":
        if len(argv) < 3:
            print("usage: decrypt <state-dir> <out-dir> [unlock-key]")
            return 2
        decrypt(state_dir, argv[2], *(argv[3:4]))
        return 0
    if cmd == "downgrade-key":
        if len(argv) < 3:
            print("usage: downgrade-key <state-dir> <unlock-key>")
            return 2
        downgrade_key(state_dir, argv[2])
        return 0
    if cmd == "renew-certs":
        nid = renew_certs(state_dir, *(argv[2:3]))
        print(f"renewed certificate for {nid}")
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":   # pragma: no cover
    sys.exit(main())
