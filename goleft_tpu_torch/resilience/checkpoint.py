"""Atomic sharded checkpoint store for cohort runs: the port's copy of
the JAX package's resilience/checkpoint.py (without ``DeferredCommits``,
which is serve's). The block format is the same, pickled values under
``key_digest`` names, so a store written by ``goleft_tpu cohortdepth``
resumes under ``goleft_tpu_torch cohortdepth``.

Layout under ``--checkpoint-dir``::

    <dir>/blocks/<keyhash>.pkl   one pickled value per shard key
    <dir>/journal.jsonl          fsync'd append-only commit journal
    <dir>/quarantine.json        (written by the CLI on degraded runs)

Write protocol (crash-safe at every point):

  1. pickle the block to ``blocks/<hash>.pkl.<pid>.tmp``, fsync it
  2. ``os.replace`` onto the final name (atomic), fsync the directory
  3. append one JSON line to the journal, flush + fsync

A shard is *committed* only once its journal line is durable — a crash
between (2) and (3) leaves an orphan block that is simply rewritten on
resume; a crash mid-(3) leaves a truncated final line that replay
tolerates. Resume (``--resume``) replays the journal, keeps entries
whose block file still exists, and the caller skips those shards.

Keys are arbitrary picklable tuples hashed by ``repr``; callers build
them from **content identity**: ``parallel.scheduler.file_key``
(path, size, mtime_ns) of each input plus the canonical parameters —
so a stale input invalidates only its own shards (its file_key
changes, its old blocks just stop matching; nothing else recomputes).

Counters: ``checkpoint.shards_written_total``,
``checkpoint.shards_resumed_total`` (journal-replay skips, the crash-
resume test's evidence), ``checkpoint.journal_entries_replayed``.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
from concurrent.futures import ThreadPoolExecutor

from ..obs import get_logger, get_registry

log = get_logger("resilience.checkpoint")

JOURNAL_NAME = "journal.jsonl"
BLOCKS_DIR = "blocks"
#: threads that write and fsync one put_many's blocks at once: the fsyncs
#: overlap, and every block is still durable before the journal commit
WRITE_THREADS = 8


class CheckpointCorrupt(RuntimeError):
    """A journaled block failed to load — external corruption (the
    write protocol cannot produce this). Clear the checkpoint dir or
    drop ``--resume``."""


def key_digest(key) -> str:
    return hashlib.sha256(repr(key).encode()).hexdigest()[:32]


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def iter_journal_lines(path: str, on_torn=None,
                       stop_on_torn: bool = True):
    """Yield parsed JSON records from an fsync'd append-only journal,
    tolerating torn lines a crash mid-append can leave. With
    ``stop_on_torn`` (the checkpoint replay contract) iteration stops
    at the first torn line: everything before it is intact and nothing
    can follow it. Without it, garbled lines are skipped one by one.
    ``on_torn()`` runs per torn line; a missing file yields nothing."""
    try:
        fh = open(path)
    except FileNotFoundError:
        return
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if on_torn is not None:
                    on_torn()
                if stop_on_torn:
                    break
                continue
            yield rec


class CheckpointStore:
    """Keyed atomic block store + fsync'd append-only run journal.

    ``resume=False`` (a fresh run into the directory) truncates the
    journal so stale completions cannot leak in; blocks from earlier
    runs are inert (unreferenced) and get overwritten as their keys
    recompute. ``resume=True`` replays the journal into the completed
    set. Thread-safe; use as a context manager or call :meth:`close`.
    """

    def __init__(self, directory: str, resume: bool = False):
        self.dir = directory
        self.resume = bool(resume)
        self._blocks = os.path.join(directory, BLOCKS_DIR)
        os.makedirs(self._blocks, exist_ok=True)
        self._journal_path = os.path.join(directory, JOURNAL_NAME)
        self._completed: dict[str, str] = {}  # keyhash -> block relpath
        # run metadata journaled via note(): merged key-wise on
        # replay, so a --resume run reads what its predecessor noted
        self.meta: dict = {}
        self._lock = threading.Lock()
        reg = get_registry()
        self._c_written = reg.counter("checkpoint.shards_written_total")
        self._c_resumed = reg.counter("checkpoint.shards_resumed_total")
        self._c_replayed = reg.counter(
            "checkpoint.journal_entries_replayed")
        self._c_commits = reg.counter(
            "checkpoint.journal_commits_total")
        if self.resume:
            self._replay()
        else:
            # fresh run: an empty, durable journal
            with open(self._journal_path, "w") as fh:
                fh.flush()
                os.fsync(fh.fileno())
        self._fh = open(self._journal_path, "a")

    def _replay(self) -> None:
        # torn final append (crash mid-write): everything before it is
        # intact, the torn shard recomputes
        for rec in iter_journal_lines(
                self._journal_path,
                on_torn=lambda: log.warning(
                    "journal %s: ignoring torn line",
                    self._journal_path)):
            m = rec.get("meta")
            if isinstance(m, dict):
                self.meta.update(m)  # later lines win
                continue
            rel = rec.get("f")
            kh = rec.get("k")
            if not kh or not rel:
                continue
            if os.path.exists(os.path.join(self.dir, rel)):
                self._completed[kh] = rel
                self._c_replayed.inc()
        log.info("journal replay: %d committed shard(s) in %s",
                 len(self._completed), self.dir)

    # ---- queries ----

    def has(self, key) -> bool:
        with self._lock:
            return key_digest(key) in self._completed

    def get(self, key, default=None):
        """Load a committed block (counted as a resumed shard);
        ``default`` when not committed. Raises
        :class:`CheckpointCorrupt` on a journaled-but-unloadable
        block."""
        kh = key_digest(key)
        with self._lock:
            rel = self._completed.get(kh)
        if rel is None:
            return default
        path = os.path.join(self.dir, rel)
        try:
            with open(path, "rb") as fh:
                val = pickle.load(fh)
        except Exception as e:  # noqa: BLE001 — any load failure
            raise CheckpointCorrupt(
                f"checkpoint block {path} for key {key!r} is "
                f"unreadable ({e!r}); clear {self.dir} or rerun "
                "without --resume") from e
        self._c_resumed.inc()
        return val

    @property
    def completed_count(self) -> int:
        with self._lock:
            return len(self._completed)

    # ---- commits ----

    def _write_block(self, key, value) -> tuple[str, str]:
        kh = key_digest(key)
        rel = os.path.join(BLOCKS_DIR, kh + ".pkl")
        path = os.path.join(self.dir, rel)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as fh:
                pickle.dump(value, fh, protocol=pickle.HIGHEST_PROTOCOL)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return kh, rel

    def _journal_commit(self, entries: list[tuple[str, str]]) -> None:
        with self._lock:
            for kh, rel in entries:
                self._fh.write(json.dumps({"k": kh, "f": rel},
                                          sort_keys=True) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            for kh, rel in entries:
                self._completed[kh] = rel
        self._c_written.inc(len(entries))
        self._c_commits.inc()  # one fsync'd journal append group

    def note(self, **fields) -> None:
        """Durably append run metadata as a ``{"meta": {...}}``
        journal line — no block, no key, same fsync discipline as a
        commit. Lines merge key-wise on replay (later lines win), so
        a ``--resume`` run reads what its predecessor measured
        instead of re-measuring; readers from before this revision
        skip the lines entirely (replay ignores records without
        k/f)."""
        if not fields:
            return
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(json.dumps({"meta": fields},
                                      sort_keys=True) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.meta.update(fields)

    def put(self, key, value) -> None:
        """Atomically persist one block and commit it to the journal."""
        self.put_many([(key, value)])

    def put_many(self, items) -> None:
        """Persist several blocks with ONE journal commit (one fsync
        pair per shard group — cohortdepth commits a region's
        per-sample columns together)."""
        items = list(items)
        if not items:
            return
        if len(items) == 1:
            entries = [self._write_block(*items[0])]
        else:
            with ThreadPoolExecutor(min(WRITE_THREADS, len(items))) as pool:
                entries = list(pool.map(lambda kv: self._write_block(*kv),
                                        items))
        _fsync_dir(self._blocks)
        self._journal_commit(entries)

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
