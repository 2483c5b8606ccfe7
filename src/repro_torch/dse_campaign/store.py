"""JSON persistence for campaigns: durable, verifiable checkpoints.

One artifact kind:
  * checkpoint — the full resumable ``Campaign.state_dict()`` (spec,
    workloads, constraint, per-workload frontier state, next tile), written
    atomically so an interrupt mid-write never corrupts the resume point.
    The schema (version 1) is the reference package's, plus a ``"dtype"``
    key naming the precision tier.

Checkpoint durability layers three defenses on the atomic rename:

  * integrity envelope — every checkpoint carries an ``"integrity"`` key
    with a CRC32 over the canonical (sorted, compact) JSON of the rest of
    the state plus a monotonically increasing generation number; loads
    verify the CRC and treat a mismatch exactly like unparseable JSON.
  * write-ahead journal — ``<path>.journal`` gets an fsync'd, CRC-stamped
    record (generation, payload CRC, byte count, next_tile) *before* the
    rename publishes the new checkpoint, so after any crash the journal
    tells you which generation was durable last and how far the campaign
    had progressed.  Torn journal lines self-identify via the per-line CRC
    prefix and are skipped.
  * generations + quarantine — each save also lands as ``<path>.g<NNN>``;
    retention keeps the newest ``keep`` generations.  A corrupt checkpoint
    is renamed aside to ``*.corrupt`` (evidence, not deleted) and the load
    falls back to the newest generation that verifies, so a flipped bit or
    truncated write costs at most ``checkpoint_every`` tiles of rework —
    never a traceback, never a silently wrong frontier.
"""

from __future__ import annotations

import json
import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

# checkpoint generations kept on disk (newest K); the published path itself
# is a hardlink/copy of the newest generation and does not count
KEEP_GENERATIONS = 3

INTEGRITY_KEY = "integrity"

_GEN_RE = re.compile(r"\.g(\d{8})$")


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed CRC/parse verification and no fallback survived."""


def _fsync_dir(d: str) -> None:
    """fsync a directory so a rename within it survives power loss.

    Best-effort: some filesystems (and non-POSIX platforms) refuse to open
    directories; the rename is still atomic in the namespace there.
    """
    try:
        fd = os.open(d or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write_text(data: str, path: str) -> int:
    """tmp + flush + fsync + rename + parent-dir fsync; returns bytes written."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    raw = data.encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # os.replace is atomic in the namespace but the *rename itself* lives in
    # the directory — without this fsync a power cut can resurrect the old
    # directory entry even though the file data was durable
    _fsync_dir(d)
    return len(raw)


def atomic_write_json(payload: Dict, path: str) -> int:
    """Write ``payload`` as JSON via tmp-file + ``os.replace``.

    The temp file is flushed and fsync'd before the rename, and the parent
    directory is fsync'd after it: ``os.replace`` is atomic in the namespace
    but says nothing about durability of either the data or the rename, so
    without both fsyncs a crash could leave a truncated-but-named checkpoint
    or roll the rename back — exactly the corruption the resume path
    assumes cannot happen.  Returns the bytes written (journal
    accounting).
    """
    return _atomic_write_text(json.dumps(payload, indent=1), path)


def checkpoint_crc(state: Dict) -> int:
    """CRC32 over the canonical JSON of ``state`` (integrity key excluded)."""
    body = {k: v for k, v in state.items() if k != INTEGRITY_KEY}
    canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(canon.encode("utf-8")) & 0xFFFFFFFF


def generation_paths(path: str) -> List[Tuple[int, str]]:
    """On-disk ``(generation, path)`` pairs for ``path``, oldest first."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        if not name.startswith(base):
            continue
        m = _GEN_RE.search(name)
        if m and name == base + m.group(0):
            out.append((int(m.group(1)), os.path.join(d, name)))
    return sorted(out)


class CheckpointJournal:
    """Append-only write-ahead journal next to a checkpoint path.

    One JSONL record per save, each line prefixed with its own CRC32
    (``"<crc32:08x> <json>\\n"``) so a torn final line after a crash is
    detected and skipped rather than mistaken for history.  Appends are
    fsync'd *before* the checkpoint rename — write-ahead: if the journal
    lacks generation N, generation N was never promised.
    """

    SUFFIX = ".journal"

    def __init__(self, checkpoint_path: str):
        self.checkpoint_path = checkpoint_path
        self.path = checkpoint_path + self.SUFFIX

    def append(self, record: Dict) -> int:
        """fsync'd append of one CRC-prefixed record; returns bytes appended."""
        body = json.dumps(record, sort_keys=True, separators=(",", ":"))
        crc = zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF
        line = f"{crc:08x} {body}\n"
        raw = line.encode("utf-8")
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "ab") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        return len(raw)

    def records(self) -> Tuple[List[Dict], int]:
        """All intact records (oldest first) and the count of torn lines."""
        if not os.path.exists(self.path):
            return [], 0
        records, torn = [], 0
        with open(self.path, "rb") as f:
            for raw in f:
                line = raw.decode("utf-8", errors="replace").rstrip("\n")
                if len(line) < 10 or line[8] != " ":
                    torn += 1
                    continue
                prefix, body = line[:8], line[9:]
                try:
                    crc = int(prefix, 16)
                except ValueError:
                    torn += 1
                    continue
                if zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF != crc:
                    torn += 1
                    continue
                try:
                    records.append(json.loads(body))
                except json.JSONDecodeError:
                    torn += 1
            return records, torn

    def last_generation(self) -> int:
        records, _ = self.records()
        gens = [int(r.get("generation", 0)) for r in records]
        return max(gens) if gens else 0


def _read_generation(path: str) -> int:
    """Generation stamped inside a checkpoint file; 0 if unreadable/legacy."""
    try:
        with open(path) as f:
            state = json.load(f)
        return int(state.get(INTEGRITY_KEY, {}).get("generation", 0))
    except (OSError, ValueError):
        return 0


def save_checkpoint(state: Dict, path: str, keep: int = KEEP_GENERATIONS,
                    journal: bool = True) -> str:
    """Persist a ``Campaign.state_dict()`` durably; returns ``path``.

    Order of operations (each step durable before the next):

    1. stamp the state with its integrity envelope (CRC32 + generation);
    2. append the write-ahead journal record (fsync'd);
    3. write the generation file ``<path>.g<NNN>`` atomically;
    4. publish it at ``path`` (hardlink + rename, copy fallback);
    5. prune generations beyond ``keep``.

    A crash between any two steps leaves either the previous checkpoint
    intact or the new one fully published — and the journal always knows
    which.
    """
    gens = generation_paths(path)
    gen = max([g for g, _ in gens] + [_read_generation(path), 0]) + 1
    body = {k: v for k, v in state.items() if k != INTEGRITY_KEY}
    crc = checkpoint_crc(body)
    stamped = dict(body)
    stamped[INTEGRITY_KEY] = {"crc32": crc, "generation": gen,
                              "algo": "crc32/json-c14n"}
    data = json.dumps(stamped, indent=1)
    if journal:
        CheckpointJournal(path).append({
            "generation": gen,
            "crc32": crc,
            "bytes": len(data.encode("utf-8")),
            "next_tile": state.get("next_tile"),
        })
    gen_path = f"{path}.g{gen:08d}"
    _atomic_write_text(data, gen_path)
    # publish as a separate inode (not a hardlink): in-place corruption of
    # the canonical file must not also corrupt the generation it falls back to
    _atomic_write_text(data, path)
    for _, old in generation_paths(path)[:-keep] if keep > 0 else []:
        try:
            os.unlink(old)
        except OSError:
            pass
    return path


def _load_verified(path: str) -> Dict:
    """Parse + CRC-verify one checkpoint file; CheckpointCorruptionError on
    any parse/CRC failure.  Legacy checkpoints without an integrity envelope
    are accepted (nothing to verify against)."""
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise CheckpointCorruptionError(
            f"checkpoint {path} is unreadable: {exc}") from exc
    if not isinstance(state, dict):
        raise CheckpointCorruptionError(
            f"checkpoint {path} is not a JSON object")
    envelope = state.get(INTEGRITY_KEY)
    if envelope is not None:
        try:
            expected = int(envelope["crc32"])
        except (TypeError, KeyError, ValueError) as exc:
            raise CheckpointCorruptionError(
                f"checkpoint {path} has a malformed integrity envelope"
            ) from exc
        actual = checkpoint_crc(state)
        if actual != expected:
            raise CheckpointCorruptionError(
                f"checkpoint {path} CRC mismatch: stored {expected:#010x}, "
                f"computed {actual:#010x}")
    return state


def _quarantine(path: str) -> Optional[str]:
    """Rename a corrupt file aside to ``<path>.corrupt`` (kept as evidence)."""
    dst = path + ".corrupt"
    try:
        os.replace(path, dst)
        _fsync_dir(os.path.dirname(path))
        return dst
    except OSError:
        return None


def load_checkpoint_recovering(path: str) -> Tuple[Dict, Dict]:
    """Load a checkpoint, surviving corruption; returns ``(state, report)``.

    The canonical file is verified first; on corruption it is quarantined to
    ``*.corrupt`` and the newest generation file that verifies is used
    instead (corrupt generations are quarantined too).  Raises
    ``CheckpointCorruptionError`` only when no copy on disk verifies, and
    ``FileNotFoundError`` when nothing exists at all.

    ``report`` keys: ``path`` (file actually loaded), ``quarantined`` (files
    renamed aside), ``fallback_generation`` (generation recovered from, or
    ``None`` when the canonical file was healthy).
    """
    report = {"path": path, "quarantined": [], "fallback_generation": None}
    candidates: List[Tuple[Optional[int], str]] = []
    if os.path.exists(path):
        candidates.append((None, path))
    candidates.extend((g, p) for g, p in reversed(generation_paths(path)))
    if not candidates:
        raise FileNotFoundError(path)
    last_exc: Optional[Exception] = None
    for gen, p in candidates:
        try:
            state = _load_verified(p)
        except CheckpointCorruptionError as exc:
            last_exc = exc
            q = _quarantine(p)
            if q:
                report["quarantined"].append(q)
            continue
        report["path"] = p
        report["fallback_generation"] = gen
        state.pop(INTEGRITY_KEY, None)
        return state, report
    raise CheckpointCorruptionError(
        f"checkpoint {path}: no valid copy on disk "
        f"(quarantined {report['quarantined']})") from last_exc


def load_checkpoint(path: str, fallback: bool = True) -> Dict:
    """Load + verify a campaign checkpoint.

    ``fallback=True`` (default) recovers from corruption via
    ``load_checkpoint_recovering``; ``fallback=False`` raises
    ``CheckpointCorruptionError`` on the first bad byte (tests, forensics).
    """
    if fallback:
        state, _ = load_checkpoint_recovering(path)
    else:
        state = _load_verified(path)
        state.pop(INTEGRITY_KEY, None)
    version = state.get("version")
    if version != 1:
        raise ValueError(f"unsupported campaign checkpoint version {version!r} "
                         f"in {path}")
    return state
