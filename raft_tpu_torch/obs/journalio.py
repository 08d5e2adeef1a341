"""Crash-safe writes and reads shared by the port's persistence tiers.

The port's copy of ``raft_tpu/obs/journalio.py`` (what the port uses of
it): one serialization for JSON records, one whole-file write (``tmp ->
fsync -> rename``) for the case journal (``recovery.CaseJournal``) and
the checkpoint store (``serve/checkpoint.CheckpointStore``) and the
result store (``serve/resultstore.py``), the line-flushed, size-rotated
JSONL writer (with the replication hooks of the serve WAL,
``serve/journal.py`` / ``serve/replica.py``) and the torn-tail-tolerant
readers of the flight recorder (``obs/events.py``) and the WAL, a
directory's byte count for the disk gauges, and the count of corrupt
entries read as misses, kept in the registry counter
``raft_tpu_journal_corrupt_total{kind}`` (``kind`` "case",
"checkpoint", "serve", "resultstore"; `corrupt_count` reads it).
"""
from __future__ import annotations

import json
import os
import threading

from raft_tpu_torch.obs import metrics as _metrics

_READ_LOCK = threading.Lock()

#: the registry counter of corrupt entries, by journal kind
CORRUPT_METRIC = "raft_tpu_journal_corrupt_total"


def _default(v):
    return str(v)


def dumps(doc: dict) -> str:
    """The one JSON serialization (compact separators, values JSON cannot
    take stringified)."""
    return json.dumps(doc, separators=(",", ":"), default=_default)


def fsync_write(path: str, data: bytes):
    """Crash-safe whole-file write: a per-writer tmp name (two writers of
    one path never truncate each other) -> write -> flush -> fsync ->
    atomic rename.  Raises on I/O trouble, after unlinking the tmp
    file; the caller owns its degradation."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def dir_bytes(path: str) -> int:
    """Total bytes of the files directly under ``path`` (every journal or
    store tier is flat), 0 when unreadable; feeds the per-component
    ``raft_tpu_disk_bytes`` gauges."""
    total = 0
    try:
        with os.scandir(path) as entries:
            for e in entries:
                try:
                    if e.is_file(follow_symlinks=False):
                        total += e.stat(follow_symlinks=False).st_size
                except OSError:
                    continue
    except OSError:
        return 0
    return total


def count_corrupt(kind: str, n: int = 1):
    """Count ``n`` corrupt entries of journal ``kind`` in
    ``raft_tpu_journal_corrupt_total{kind}`` (never raises)."""
    if n <= 0:
        return
    try:
        _metrics.counter(
            CORRUPT_METRIC,
            "torn/corrupt journal entries treated as misses on read, "
            "by journal kind").inc(float(n), kind=str(kind))
    except Exception:                                 # pragma: no cover
        pass


def corrupt_count(kind: str) -> int:
    """The corrupt entries of journal ``kind`` counted so far (0 when
    none, or after a registry reset)."""
    m = _metrics.snapshot().get(CORRUPT_METRIC) or {}
    return int(sum(s["value"] for s in m.get("series", [])
                   if s["labels"].get("kind") == str(kind)))


class JsonlWriter:
    """One append-only, line-flushed JSONL file with size rotation.

    Not thread-safe on its own (the flight recorder and the serve journal
    hold their own locks).  ``header`` (optional) is called as
    ``header(part)`` after every fresh open, the first included, and its
    dict becomes the part's first record, so a rotated generation is
    self-describing.  When a part outgrows ``max_bytes`` it moves to
    ``<path>.1`` (older generations shuffle up, the newest ``keep`` are
    kept).

    Replication hooks (optional; a hook that fails never fails the
    write): ``post_flush(writer)`` runs after every record's write and
    flush, while the caller's lock is held (the serve WAL mirror ships
    the fresh bytes there); ``post_rotate(writer, sealed_part)`` runs
    after a rotation sealed a part, before the fresh part opens."""

    def __init__(self, path: str, *, max_bytes: int = None, keep: int = 2,
                 header=None, post_flush=None, post_rotate=None):
        self.path = str(path)
        self.max_bytes = max_bytes
        self.keep = max(0, int(keep))
        self.part = 0
        self._header = header
        self.post_flush = post_flush
        self.post_rotate = post_rotate
        self._fh = None
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        self._open_fresh()

    def _open_fresh(self):
        self._fh = open(self.path, "a", encoding="utf-8")
        if self._header is not None:
            doc = self._header(self.part)
            if doc:
                self.write(dict(doc), rotate=False)

    def write(self, doc: dict, rotate: bool = True):
        """Serialize one record, write it, flush; then rotate if the part
        outgrew ``max_bytes``.  Raises on I/O trouble."""
        self._fh.write(dumps(doc) + "\n")
        self._fh.flush()
        if self.post_flush is not None:
            try:
                self.post_flush(self)
            except Exception:                        # pragma: no cover
                pass
        if rotate and self.max_bytes is not None \
                and self._fh.tell() > self.max_bytes:
            self.rotate()

    def rotate(self):
        """Close the current part and open a fresh one, the closed part at
        ``<path>.1`` (older ones shuffle up; past ``keep`` dropped)."""
        try:
            self._fh.close()
        except OSError:                              # pragma: no cover
            pass
        if self.keep <= 0:
            try:
                os.remove(self.path)
            except OSError:                          # pragma: no cover
                pass
        else:
            for i in range(self.keep - 1, 0, -1):
                src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
                if os.path.exists(src):
                    try:
                        os.replace(src, dst)
                    except OSError:                  # pragma: no cover
                        pass
            try:
                os.replace(self.path, self.path + ".1")
            except OSError:                          # pragma: no cover
                pass
        self.part += 1
        # before the fresh part opens (and writes its header): a mirror
        # shuffles its generations while the sealed bytes still name the
        # live path
        if self.post_rotate is not None:
            try:
                self.post_rotate(self, self.part - 1)
            except Exception:                        # pragma: no cover
                pass
        self._open_fresh()

    def tell(self) -> int:
        return self._fh.tell()

    def close(self):
        """Close the stream (idempotent)."""
        if self._fh is None:
            return
        try:
            self._fh.close()
        except OSError:                              # pragma: no cover
            pass
        self._fh = None

    @property
    def closed(self) -> bool:
        return self._fh is None

    def tear_tail(self, nbytes: int = 7):
        """Truncate the file mid-record: what a crash between the write
        and the flush of the next record looks like (the ``torn@journal``
        fault action only; readers skip the torn line)."""
        try:
            self._fh.flush()
            end = self._fh.tell()
            self._fh.close()
            with open(self.path, "ab") as f:
                f.truncate(max(0, end - int(nbytes)))
            self._fh = open(self.path, "a", encoding="utf-8")
        except OSError:                              # pragma: no cover
            pass


def read(path: str, kind: str = None) -> list[dict]:
    """Parse one JSONL file, skipping any unparseable line (the torn
    final line of a killed writer); with ``kind`` the skipped lines are
    counted as corrupt entries of that kind."""
    return read_counted(path, kind)[0]


def read_counted(path: str, kind: str = None) -> tuple[list[dict], int]:
    """`read` plus the number of skipped lines."""
    out = []
    bad = 0
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except json.JSONDecodeError:
                    bad += 1
                    continue
                if isinstance(doc, dict):
                    out.append(doc)
                else:
                    bad += 1
    except OSError:
        return [], 0
    if kind is not None and bad:
        with _READ_LOCK:
            count_corrupt(kind, bad)
    return out, bad


def read_incremental(path: str, offset: int = 0) -> tuple[list[dict], int]:
    """Parse only the complete lines at byte ``offset`` and beyond;
    returns ``(records, new_offset)``.  A torn final line is left for the
    next call; a file smaller than ``offset`` means it rotated (re-enter
    at 0)."""
    try:
        with open(path, "rb") as f:
            f.seek(int(offset))
            data = f.read()
    except OSError:
        return [], offset
    end = data.rfind(b"\n")
    if end < 0:
        return [], offset
    out = []
    for raw in data[:end].split(b"\n"):
        if not raw.strip():
            continue
        try:
            doc = json.loads(raw.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue
        if isinstance(doc, dict):
            out.append(doc)
    return out, int(offset) + end + 1
