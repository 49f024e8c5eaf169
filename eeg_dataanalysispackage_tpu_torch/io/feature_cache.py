"""Content-addressed on-disk cache of extracted feature matrices.

The port's copy of the JAX package's ``io/feature_cache.py``, with its
key scheme and entry format, so the two packages read each other's
entries: both default to ``~/.cache/eeg-tpu/feature-cache``. The
reference re-reads and re-featurizes every BrainVision recording on
every run (PipelineBuilder.java:94-295); here the ``(n, d)`` feature
matrix and its ``(n,)`` float64 targets are stored once per *content
key*, and a re-run loads them instead of re-parsing, re-staging and
re-running the kernel: a hit launches no ingest or epoch-features
kernel.

Key scheme (all content, no paths or mtimes)::

    blake2b(
        per-recording [relative path, guessed number,
                       sha256(.vhdr + .vmrk + .eeg bytes)] in load order
        + channel set + epoch window (pre, post)
        + extractor id/config (the fused family's geometry and
          precision class, or a seizure run's extractor cache_id and
          window geometry)
    )

so editing any byte of any file of the run, changing the guessed
number, the channel selection, the window or the extractor
configuration all invalidate naturally: there is nothing to expire.
The key does not name the fused backend spelling: every spelling runs
the one kernel.

Storage is one ``.npz`` per key under the cache directory, written
atomically (tmp + ``os.replace``), so a crash mid-store never leaves a
truncated entry. A corrupt or truncated entry (failed ``np.load``,
missing arrays, shape mismatch) is treated as a miss: counted, deleted
best-effort and rebuilt.

Configuration:

- ``EEG_TPU_FEATURE_CACHE_DIR``: the cache directory (default: the
  per-user scratch ``~/.cache/eeg-tpu/feature-cache``, under
  ``XDG_CACHE_HOME`` when that is set);
- ``EEG_TPU_NO_FEATURE_CACHE=1``: disable everywhere;
- ``cache=false`` query parameter: disable for one run.

Hits, misses and corrupt entries land in ``obs.metrics``
(``feature_cache.*``) and :func:`stats`, which the run report embeds
as ``caches.feature_cache``.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: sentinel from ``FeatureCache._acquire_fs_lock``: a live foreign
#: process holds the key (non-blocking callers treat it like an
#: in-process holder)
_FOREIGN_HELD = object()

#: cache directory override (explicit argument wins over it).
ENV_DIR = "EEG_TPU_FEATURE_CACHE_DIR"
#: set to "1" to disable the feature cache everywhere.
ENV_DISABLE = "EEG_TPU_NO_FEATURE_CACHE"

_FORMAT_VERSION = 1

_lock = threading.Lock()
_hits = 0
_misses = 0
_corrupt = 0
_cross_process_waits = 0

# -- single-flight rebuild guard ----------------------------------------
# Two pipeline runs (two plans under the multi-tenant executor, or two
# threads in one process) that MISS the same entry would both pay the
# full ingest+featurize rebuild and then race the atomic rename — the
# loser's identical bytes win the os.replace, but an entire rebuild
# was wasted. The guard serializes rebuilds per (directory, key): the
# first builder through proceeds; concurrent builders of the SAME key
# block until it finishes, then revalidate (lookup again) and hit the
# entry the leader stored. The in-process half is a condition
# variable; ACROSS processes (N local pipeline processes cold-starting
# the same session — the pod harness, N gateways on one box) a
# best-effort O_EXCL lock file beside the entry extends the same
# single-flight: foreign-process waiters poll until the lock clears or
# the entry lands (counted as ``feature_cache.cross_process_waits``),
# with a deadline-aware timeout fallback — a stale lock (dead holder)
# or a spent budget stops the wait and the caller proceeds lock-free,
# because the lock only ever saves redundant work; correctness is the
# atomic rename's.
_flight_cond = threading.Condition(_lock)
_flights: set = set()

#: max seconds a cross-process waiter polls a foreign lock, and the
#: age past which a lock file is presumed abandoned (its holder died
#: without the ``finally`` that unlinks it)
ENV_LOCK_TIMEOUT = "EEG_TPU_CACHE_LOCK_TIMEOUT_S"
_DEFAULT_LOCK_TIMEOUT_S = 30.0
_LOCK_POLL_S = 0.05


def lock_timeout() -> float:
    value = os.environ.get(ENV_LOCK_TIMEOUT)
    if not value:
        return _DEFAULT_LOCK_TIMEOUT_S
    try:
        return float(value)
    except ValueError:
        logger.warning(
            "unparseable %s=%r; using the default %.0fs",
            ENV_LOCK_TIMEOUT, value, _DEFAULT_LOCK_TIMEOUT_S,
        )
        return _DEFAULT_LOCK_TIMEOUT_S


class BuildSlot:
    """The single-flight token for one entry rebuild. ``waited`` is
    True when another builder held the key while we arrived — the
    signal to revalidate before rebuilding. Release exactly once, in
    a ``finally``: a leader that died without releasing would block
    every waiter forever (the in-process half; the on-disk half
    self-heals via the stale-lock age)."""

    __slots__ = ("_token", "waited", "_released", "_lock_path")

    def __init__(self, token, waited: bool, lock_path=None):
        self._token = token
        self.waited = waited
        self._released = False
        self._lock_path = lock_path

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._lock_path is not None:
            # unlink only OUR lock: a build that outlived the stale
            # age may have had its lock broken and re-taken by
            # another process (whose pid is now in the file) —
            # deleting that live lock would invite a third rebuild
            try:
                with open(self._lock_path) as f:
                    owner = f.read().strip()
                if owner == str(os.getpid()):
                    os.unlink(self._lock_path)
            except OSError:
                pass
        with _flight_cond:
            _flights.discard(self._token)
            _flight_cond.notify_all()


def default_cache_dir() -> str:
    """Per-user scratch default (XDG-style), sibling of the persistent
    compile cache's default."""
    root = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(root, "eeg-tpu", "feature-cache")


def resolve_cache_dir(path: Optional[str] = None) -> Optional[str]:
    """The directory the cache should use, or None when disabled.
    Precedence: explicit ``path`` > ``EEG_TPU_FEATURE_CACHE_DIR`` >
    the per-user default; ``EEG_TPU_NO_FEATURE_CACHE=1`` wins over
    everything."""
    if os.environ.get(ENV_DISABLE) == "1":
        return None
    return path or os.environ.get(ENV_DIR) or default_cache_dir()


def stats() -> Dict[str, int]:
    """Process-wide hit/miss/corrupt counters: the run report's
    ``caches.feature_cache`` (zeros when the cache never ran, like
    ``plan_cache.stats``)."""
    with _lock:
        return {
            "hits": _hits,
            "misses": _misses,
            "corrupt": _corrupt,
            "cross_process_waits": _cross_process_waits,
        }


def reset_stats() -> None:
    """Zero the counters."""
    global _hits, _misses, _corrupt, _cross_process_waits
    with _lock:
        _hits = _misses = _corrupt = _cross_process_waits = 0


def _count_cross_process_wait() -> None:
    global _cross_process_waits
    with _lock:
        _cross_process_waits += 1


def _count(kind: str) -> None:
    global _hits, _misses, _corrupt
    from .. import obs
    from ..obs import events

    with _lock:
        if kind == "hit":
            _hits += 1
        elif kind == "miss":
            _misses += 1
        else:
            _corrupt += 1
    obs.metrics.count(f"feature_cache.{kind}")
    # telemetry: hit/miss/corrupt as span events, so a run report's
    # trace shows WHERE in the run the cache decided (no-op when off)
    events.event(f"feature_cache.{kind}")


def run_key(content_digests, channel_names, pre: int, post: int,
            extractor: Tuple) -> str:
    """Content key for one pipeline run's feature matrix.

    ``content_digests`` is the ordered ``(rel_path, guessed, digest)``
    list from ``OfflineDataProvider.content_digests()`` — the files
    that will actually load, in load order (cross-file balance state
    makes the feature/target rows a function of the whole ordered run,
    so per-run is the finest sound granularity). ``extractor`` is the
    static id/config tuple, e.g. ``("dwt-fused", 8, 512, 175, 16)``.
    """
    h = hashlib.blake2b(digest_size=20)
    h.update(b"eeg-tpu-feature-cache-v%d" % _FORMAT_VERSION)
    for rel_path, guessed, digest in content_digests:
        h.update(repr((rel_path, int(guessed), digest)).encode())
    h.update(repr(tuple(channel_names)).encode())
    h.update(repr((int(pre), int(post))).encode())
    h.update(repr(tuple(extractor)).encode())
    return h.hexdigest()


class FeatureCache:
    """One directory of content-addressed ``(features, targets)``
    entries. Construct via :func:`open_cache`."""

    def __init__(self, directory: str):
        self.directory = directory

    def _entry_path(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}.npz")

    def lookup(self, key: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(features, targets) for ``key``, or None on a miss. Corrupt
        entries count as misses and are removed best-effort."""
        path = self._entry_path(key)
        if not os.path.exists(path):
            _count("miss")
            return None
        try:
            with np.load(path, allow_pickle=False) as data:
                features = np.asarray(data["features"])
                targets = np.asarray(data["targets"])
            if features.ndim != 2 or targets.shape != (features.shape[0],):
                raise ValueError(
                    f"inconsistent entry shapes {features.shape} / "
                    f"{targets.shape}"
                )
        except Exception as e:
            # truncated write survivor, zip damage, missing arrays:
            # the entry is dead weight — drop it and rebuild
            logger.warning(
                "feature cache entry %s is corrupt (%s: %s); treating "
                "as a miss", path, type(e).__name__, e,
            )
            _count("corrupt")
            _count("miss")
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        _count("hit")
        return features, targets

    def begin_build(self, key: str) -> BuildSlot:
        """Enter the single-flight section for ``key``'s rebuild:
        returns immediately for the first builder, blocks while
        another in-process builder holds the key. When the returned
        slot says ``waited``, the caller should revalidate with
        :meth:`lookup` before rebuilding — the leader almost certainly
        stored the entry (counted as ``feature_cache.single_flight_wait``).
        Pair with ``slot.release()`` in a ``finally``.

        The wait honours the ambient :mod:`~.deadline` scope via
        :func:`~.deadline.cond_wait`: a deadline-bearing plan queued
        behind another tenant's long rebuild fails fast with
        :class:`~.deadline.DeadlineExceededError` instead of blocking
        past its budget (the wait re-checks in short slices — the
        scheduler's deadline contract would otherwise stop at attempt
        boundaries).

        Cross-process, the same single-flight extends via a
        best-effort ``<key>.npz.lock`` O_EXCL file: a foreign
        process's rebuild makes this builder poll (counted —
        ``feature_cache.cross_process_waits``) until the lock clears
        or the entry lands, then revalidate like an in-process
        waiter. The fallback ladder keeps it strictly best-effort —
        stale lock (holder died), spent deadline budget, or the
        ``EEG_TPU_CACHE_LOCK_TIMEOUT_S`` ceiling all stop the wait
        and proceed lock-free (N redundant builds converge through
        the atomic rename exactly as before the lock existed)."""
        from .. import obs
        from . import deadline as deadline_mod

        token = (self.directory, key)
        waited = False
        with _flight_cond:
            if token in _flights:
                waited = True
                deadline_mod.cond_wait(
                    _flight_cond,
                    lambda: token not in _flights,
                    f"single-flight wait for feature cache entry {key}",
                )
            _flights.add(token)
        if waited:
            obs.metrics.count("feature_cache.single_flight_wait")
        try:
            lock_path = self._acquire_fs_lock(key, blocking=True)
        except BaseException:
            with _flight_cond:
                _flights.discard(token)
                _flight_cond.notify_all()
            raise
        return BuildSlot(token, waited, lock_path=lock_path)

    def try_begin_build(self, key: str) -> Optional[BuildSlot]:
        """Non-blocking :meth:`begin_build`: the slot, or None when
        another builder — in this process or, via a fresh foreign
        lock file, in another — holds the key. For store-only callers
        whose features are already computed — waiting would buy
        nothing (the holder is building this same content-addressed
        entry), and a deadline-bearing plan must not die queued
        behind a store it can simply skip."""
        token = (self.directory, key)
        with _flight_cond:
            if token in _flights:
                return None
            _flights.add(token)
        try:
            lock_path = self._acquire_fs_lock(key, blocking=False)
        except BaseException:
            with _flight_cond:
                _flights.discard(token)
                _flight_cond.notify_all()
            raise
        if lock_path is _FOREIGN_HELD:
            with _flight_cond:
                _flights.discard(token)
                _flight_cond.notify_all()
            return None
        return BuildSlot(token, False, lock_path=lock_path)

    def _lock_path_for(self, key: str) -> str:
        return self._entry_path(key) + ".lock"

    def _try_create_lock(self, path: str):
        """O_EXCL create: True = acquired, False = a live foreign
        holder, None = locking unavailable here (unwritable dir —
        best-effort means proceed without)."""
        try:
            os.makedirs(self.directory, exist_ok=True)
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        except OSError:
            return None
        try:
            os.write(fd, str(os.getpid()).encode())
        finally:
            os.close(fd)
        return True

    def _lock_is_stale(self, path: str) -> bool:
        try:
            age = max(0.0, time.time() - os.path.getmtime(path))
        except OSError:
            return False  # gone already — the caller re-checks
        return age > lock_timeout()

    def _acquire_fs_lock(self, key: str, blocking: bool):
        """The cross-process half of the single-flight. Returns the
        owned lock path; None to proceed lock-free (locking
        unavailable, timeout/deadline fallback, or the entry landed
        while waiting — the caller's revalidating lookup will hit);
        or ``_FOREIGN_HELD`` (non-blocking callers only — a live
        foreign builder holds the key)."""
        from .. import obs
        from . import deadline as deadline_mod

        path = self._lock_path_for(key)
        created = self._try_create_lock(path)
        if created is True:
            return path
        if created is None:
            return None
        if not blocking:
            if self._lock_is_stale(path):
                # break the dead holder's lock so the NEXT builder is
                # not fooled too, then take it if we win the race
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return path if self._try_create_lock(path) is True else None
            return _FOREIGN_HELD
        obs.metrics.count("feature_cache.cross_process_waits")
        _count_cross_process_wait()
        wait_deadline = time.time() + lock_timeout()
        while True:
            if os.path.exists(self._entry_path(key)):
                # the foreign builder stored the entry: stop waiting —
                # the caller's revalidating lookup hits it
                return None
            if self._lock_is_stale(path):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            created = self._try_create_lock(path)
            if created is True:
                return path
            if created is None:
                return None
            ambient = deadline_mod.active_deadline()
            if ambient is not None and ambient.expired:
                # deadline-aware fallback: a budget-bearing plan must
                # not die polling a lock that only saves redundant
                # work — proceed lock-free; its own work (or the
                # scope's next check) spends the budget honestly
                return None
            if time.time() >= wait_deadline:
                logger.warning(
                    "feature cache lock %s still held after %.0fs; "
                    "proceeding without it", path, lock_timeout(),
                )
                return None
            time.sleep(_LOCK_POLL_S)

    def store(self, key: str, features: np.ndarray,
              targets: np.ndarray) -> Optional[str]:
        """Atomically persist an entry; returns its path, or None when
        the directory is unwritable (a broken scratch dir must never
        kill the run that just computed the features)."""
        from .. import obs
        from .modelfiles import atomic_write_bytes

        buf = io.BytesIO()
        np.savez(
            buf,
            features=np.asarray(features),
            targets=np.asarray(targets),
        )
        path = self._entry_path(key)
        try:
            os.makedirs(self.directory, exist_ok=True)
            atomic_write_bytes(path, buf.getvalue())
        except OSError as e:
            logger.warning(
                "feature cache store failed for %s (%s); continuing "
                "uncached", path, e,
            )
            return None
        obs.metrics.count("feature_cache.store")
        return path


def open_cache(path: Optional[str] = None) -> Optional[FeatureCache]:
    """The cache for the resolved directory, or None when disabled."""
    d = resolve_cache_dir(path)
    if d is None:
        return None
    return FeatureCache(d)
