"""Offline data provider: info.txt / .eeg inputs -> epochs or features.

Port of the JAX package's ``io/provider.OfflineDataProvider`` for one
device: :meth:`OfflineDataProvider.load` gives host epochs (the ``fe=``
path), :meth:`OfflineDataProvider.load_sliding` the seizure workload's
sliding windows, :meth:`OfflineDataProvider.load_features_device` fused
DWT features with no host epochs. Input-contract parity with
``DataTransformation/OffLineDataProvider.java``:

- args ``[<info.txt path>]`` or ``[<.eeg path>, <guessed number>]``
  (OffLineDataProvider.java:111-141);
- info.txt entries are resolved against the info.txt's directory (:129);
- duplicate info.txt entries collapse, first-seen order, last guess
  wins (LinkedHashMap semantics — :53, :308);
- files whose .vhdr/.vmrk/.eeg sibling is missing are skipped with a
  log, not fatal (:154-161);
- channels named fz/cz/pz (case-insensitive) are selected, and a file
  missing one reuses the index resolved for the previous file (:172-183);
- the balance counters span all files of a run, in info.txt order (:58-59).

Multi-file runs parse their triplets in a bounded thread pool
(``workers=``, ``ingest_workers=`` in a query, ``EEG_TPU_INGEST_WORKERS``;
default ``min(4, cpu count)``) with ``workers + prefetch_depth`` triplets
in flight, merged back in info.txt order, so every output is bit-equal to
the sequential loop at any pool size: the balance scan, the stale
channel-index reuse and the ingest planner run on one thread in order,
never in the pool. An installed fault plan clamps the pool to 1, so a
chaos replay stays deterministic.

The feature cache's key comes from one read pass
(:meth:`OfflineDataProvider.prepare_fused_run`): every triplet's bytes
are read once, digested and parsed, and on a miss the parsed recordings
are featurized from memory. The per-run precision gate's decision is
memoized under the first recording's content digest, so a re-run of the
same session replays it (``cached: True``) instead of featurizing twice.

Every read goes through a filesystem chosen by the first argument's URI
scheme (``io/remote.filesystem_for``: ``http(s)://``, ``gs://``,
``hdfs://``, local paths), or through the ``filesystem=`` given, as in
the JAX package (``io/provider.py:208-230``): the reference reads its
sessions from HDFS (``OffLineDataProvider.java:90``).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import inspect
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import brainvision, remote, sources, staging
from . import ENV_PREFETCH_DEPTH, default_prefetch_depth, env_int  # noqa: F401
from .. import obs
from ..epochs import extractor
from ..epochs.extractor import BalanceState
from ..obs import chaos, domain as run_domain, events
from ..ops import decode_ingest, device_ingest, ingest_cuda
from ..utils import constants
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

#: the JAX package's fused backend names; each runs the one CUDA kernel
FUSED_BACKENDS = ("decode", "pallas", "block", "xla")

_USAGE = (
    "Please enter the input in one of these formats: "
    "1. <location of info.txt file> "
    "2. <location of a .eeg file> <guessed number> *<optional values>"
)


#: the parse pool's size for multi-file runs when the caller pins none
#: (a query's ``ingest_workers=`` pins it per run); the look-ahead beyond
#: the parses in flight is the shared ``EEG_TPU_PREFETCH_DEPTH``
ENV_INGEST_WORKERS = "EEG_TPU_INGEST_WORKERS"
_DEFAULT_INGEST_WORKERS = 4


def default_ingest_workers() -> int:
    """The env override, else ``min(4, cpu count)``: reading and the
    native parse and demux release the GIL, and past a few workers the
    ordered merge is the bottleneck, not parsing."""
    if os.environ.get(ENV_INGEST_WORKERS):
        return env_int(ENV_INGEST_WORKERS, _DEFAULT_INGEST_WORKERS)
    return min(_DEFAULT_INGEST_WORKERS, os.cpu_count() or 1)


#: ``EEG_TPU_OVERLAP=1`` turns the overlapped fused ingest on process-wide
#: (a query's ``overlap=`` decides per run)
ENV_OVERLAP = "EEG_TPU_OVERLAP"


def default_overlap() -> bool:
    """Whether :meth:`OfflineDataProvider.load_features_device` overlaps
    when its caller does not say: ``EEG_TPU_OVERLAP=1``."""
    return os.environ.get(ENV_OVERLAP) == "1"


#: re-exported: ``info.txt`` parsing lives in ``io/sources.py``
parse_info_txt = sources.parse_info_txt

# -- precision-gate memo ---------------------------------------------
# The gate's decision is pure (content bytes x geometry x tolerance ->
# record), and the double featurize behind it is paid once per content:
# a bounded, thread-safe LRU keyed on the first recording's digest.
_GATE_MEMO: "collections.OrderedDict" = collections.OrderedDict()
_GATE_MEMO_CAP = 32
_GATE_MEMO_LOCK = threading.Lock()


def _gate_memo_get(key):
    with _GATE_MEMO_LOCK:
        record = _GATE_MEMO.get(key)
        if record is not None:
            _GATE_MEMO.move_to_end(key)
        return record


def _gate_memo_put(key, record) -> None:
    with _GATE_MEMO_LOCK:
        _GATE_MEMO[key] = dict(record)
        _GATE_MEMO.move_to_end(key)
        while len(_GATE_MEMO) > _GATE_MEMO_CAP:
            _GATE_MEMO.popitem(last=False)


def reset_gate_memo() -> None:
    """Drop the memoized gate decisions."""
    with _GATE_MEMO_LOCK:
        _GATE_MEMO.clear()


def fused_extractor_id(wavelet_index: int, precision: str = "f32") -> Tuple:
    """The fused path's extractor id tuple (a feature-cache key part),
    taken from :meth:`OfflineDataProvider.load_features_device`'s own
    parameter defaults, so the key follows the geometry the kernel runs.
    A non-f32 precision folds its class into the key: a reduced-precision
    matrix never serves an f32 request or the other way round. The
    tuple is the JAX package's, so the packages share entries."""
    defaults = {
        k: p.default
        for k, p in inspect.signature(
            OfflineDataProvider.load_features_device
        ).parameters.items()
        if p.default is not inspect.Parameter.empty
    }
    base = (
        "dwt-fused",
        int(wavelet_index),
        defaults["epoch_size"],
        defaults["skip_samples"],
        defaults["feature_size"],
    )
    if precision == "f32":
        return base
    return base + (str(precision),)


@dataclasses.dataclass
class PreparedRun:
    """One read pass's products: the feature-cache key and the parsed
    recordings behind it (a miss featurizes them from memory, so a cold
    cached run reads each file once)."""

    key: str
    recordings: List[Tuple[str, int, "brainvision.Recording"]]
    #: the ordered ``(rel_path, guessed, content digest)`` triples behind
    #: ``key``: a further extractor config keys from them without a
    #: second read (:meth:`OfflineDataProvider.run_key_for`)
    digests: List[Tuple[str, int, str]] = dataclasses.field(default_factory=list)


class OfflineDataProvider:
    """Loads BrainVision recordings into balanced P300 epochs on the host
    (:meth:`load`) or featurizes them on ``device``
    (:meth:`load_features_device`; ``None`` -> ``cuda``, raises without
    a card). ``filesystem``: an ``io.sources`` filesystem every read
    goes through; ``None`` routes by the first argument's URI scheme.
    ``workers``: the parse pool's size (``None``:
    :func:`default_ingest_workers`); ``prefetch_depth``: the parsed
    triplets queued beyond the ones in flight (``None``:
    ``EEG_TPU_PREFETCH_DEPTH``, default 2)."""

    def __init__(
        self,
        args: Sequence[str],
        filesystem: Optional[sources.FileSystem] = None,
        channel_names: Sequence[str] = constants.CHANNEL_NAMES,
        pre: int = constants.PRESTIMULUS_SAMPLES,
        post: int = constants.POSTSTIMULUS_SAMPLES,
        device: Optional[Union[str, torch.device]] = None,
        workers: Optional[int] = None,
        prefetch_depth: Optional[int] = None,
    ):
        args = [a for a in args if a is not None]
        if len(args) == 0 or len(args) > 6:
            raise ValueError(_USAGE)
        self._args = list(args)
        self._fs = filesystem if filesystem is not None else remote.filesystem_for(self._args[0])
        self._channel_names = [c.lower() for c in channel_names]
        self._pre = pre
        self._post = post
        self.device = resolve_device(device)
        self._workers = max(1, int(workers)) if workers is not None else default_ingest_workers()
        self._prefetch_depth = (max(1, int(prefetch_depth)) if prefetch_depth is not None
                                else default_prefetch_depth())
        self._last_indices: Dict[str, int] = {c: 0 for c in self._channel_names}
        self._batch: Optional[extractor.EpochBatch] = None
        #: wall seconds of the last load (parse, epoch) or
        #: load_features_device (parse, stage, featurize; featurize
        #: ends in a device sync; under overlap also wall), by stage
        self.timings: Dict[str, float] = {}

    def _resolve_files(self) -> Tuple[str, Dict[str, int]]:
        """Returns (prefix, ordered {path: guessed number})."""
        loc = self._args[0]
        if loc.endswith(constants.EEG_EXTENSION):
            if len(self._args) < 2:
                raise ValueError(
                    "A .eeg input requires a guessed number: "
                    "<location of a .eeg file> <guessed number>"
                )
            return "", {loc: int(self._args[1])}
        if loc.endswith(".txt"):
            prefix = loc[: loc.rfind("/")] + "/" if "/" in loc else ""
            return prefix, sources.parse_info_txt(self._fs.read_text(loc))
        raise ValueError(_USAGE)

    @property
    def pre(self) -> int:
        """Prestimulus window samples (epoch geometry)."""
        return self._pre

    @property
    def post(self) -> int:
        """Poststimulus window samples (epoch geometry)."""
        return self._post

    @property
    def n_channels(self) -> int:
        """Selected channel count (the feature row's channel axis)."""
        return len(self._channel_names)

    def iter_recordings(
        self,
    ) -> Iterator[Tuple[str, int, brainvision.Recording]]:
        """``(rel_path, guessed, recording)`` per triplet in info.txt
        order; files with a missing sibling are skipped with a log. The
        batch path and the serving layer (serve/pipeline.py) both read
        the session through it."""
        for rel_path, guessed, rec, _digest in self._iter_recordings():
            yield rel_path, guessed, rec

    def _resolved_workers(self, n_files: int) -> int:
        """The parse pool's size for a run of ``n_files``. A chaos replay
        counts injection-point calls in call order, which a parallel
        parse would scramble: an installed fault plan clamps the pool to
        1."""
        if chaos.active_plan() is not None:
            return 1
        return min(self._workers, n_files)

    def _read_recording(
        self, eeg_path: str, digest: bool = False,
    ) -> Tuple[brainvision.Recording, Optional[str]]:
        """Read one triplet, one read per file (counted in
        ``ingest.file_reads``; ``FileNotFoundError`` when a sibling is
        missing, as ``setFileNames`` finds, OffLineDataProvider.java:327-365),
        and parse it; with ``digest``, the sha256 of the triplet's bytes
        (.vhdr, .vmrk, .eeg), computed from the bytes this call read."""
        base = os.path.splitext(eeg_path)[0]
        triplet = (base + ".vhdr", base + ".vmrk", eeg_path)
        for p in triplet:
            if not self._fs.exists(p):
                raise FileNotFoundError(f"No related file found: {p}")
        blobs = [self._fs.read_bytes(p) for p in triplet]
        obs.metrics.count("ingest.file_reads", 3)
        fingerprint = None
        if digest:
            h = hashlib.sha256()
            for blob in blobs:
                h.update(blob)
            fingerprint = h.hexdigest()
        return brainvision.load_recording_bytes(*blobs), fingerprint

    def _iter_recordings(
        self, with_digests: bool = False,
    ) -> Iterator[Tuple[str, int, brainvision.Recording, Optional[str]]]:
        """``(rel_path, guessed, recording, digest)`` in info.txt order
        (``digest`` None unless ``with_digests``). Each parse is an
        ``ingest.parse`` span.

        With a pool of more than one worker, ``workers + prefetch_depth``
        triplets are read, digested and parsed in flight on the pool's
        threads (which adopt the run's domain; their spans carry
        ``pooled=True``), and the results come back in info.txt order.
        A file with a missing sibling is skipped with a log line; any
        other error surfaces at the file's place in the order. A consumer
        that stops early cancels the queued parses."""
        prefix, files = self._resolve_files()
        items = list(files.items())
        workers = self._resolved_workers(len(items))
        if workers <= 1:
            for rel_path, guessed in items:
                try:
                    with events.span("ingest.parse", file=rel_path):
                        rec, fingerprint = self._read_recording(prefix + rel_path, with_digests)
                except FileNotFoundError as e:
                    logger.warning("Did not load %s: %s", rel_path, e)
                    continue
                yield rel_path, guessed, rec, fingerprint
            return

        obs.metrics.gauge("ingest.parallel_workers", workers)
        domain = run_domain.capture()

        def parse_one(path: str, rel_path: str):
            with run_domain.adopt(domain), events.span("ingest.parse", file=rel_path,
                                                       pooled=True):
                return self._read_recording(path, with_digests)

        depth = workers + self._prefetch_depth
        pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="eeg-tpu-ingest")
        pending: "collections.deque" = collections.deque()
        idx = 0
        try:
            while idx < len(items) or pending:
                while idx < len(items) and len(pending) < depth:
                    rel_path, guessed = items[idx]
                    pending.append((rel_path, guessed,
                                    pool.submit(parse_one, prefix + rel_path, rel_path)))
                    idx += 1
                rel_path, guessed, future = pending.popleft()
                try:
                    rec, fingerprint = future.result()
                except FileNotFoundError as e:
                    logger.warning("Did not load %s: %s", rel_path, e)
                    continue
                obs.metrics.count("ingest.files_parsed")
                yield rel_path, guessed, rec, fingerprint
        finally:
            # a consumer that stopped early, or a parse that failed: the
            # queued parses are cancelled, the running ones finish alone
            pool.shutdown(wait=False, cancel_futures=True)

    def prepare_fused_run(self, extractor_id: Tuple) -> PreparedRun:
        """One read pass giving both the feature-cache key and the parsed
        recordings (the JAX package's ``prepare_fused_run``): the caller
        looks the key up, and on a miss hands ``recordings`` to
        :meth:`load_features_device`, which featurizes them without a
        second read. Files with a missing sibling are skipped as
        :meth:`load` skips them, so the key fingerprints the run that
        happens. Its wall seconds are ``timings["parse"]``."""
        from . import feature_cache

        t0 = time.perf_counter()
        recordings, digests = [], []
        for rel_path, guessed, rec, digest in self._iter_recordings(with_digests=True):
            recordings.append((rel_path, guessed, rec))
            digests.append((rel_path, guessed, digest))
        key = feature_cache.run_key(digests, self._channel_names, self._pre, self._post,
                                    extractor_id)
        self.timings = {"parse": time.perf_counter() - t0}
        return PreparedRun(key=key, recordings=recordings, digests=digests)

    #: the one-read-pass seam is extractor-agnostic: the seizure path
    #: keys its windows' features through it too
    prepare_run = prepare_fused_run

    def run_key_for(self, prepared: PreparedRun, extractor_id: Tuple) -> str:
        """A further extractor config's cache key over a
        :class:`PreparedRun`'s digests: no re-read, no re-digest."""
        from . import feature_cache

        return feature_cache.run_key(prepared.digests, self._channel_names, self._pre,
                                     self._post, extractor_id)

    def content_digests(self) -> List[Tuple[str, int, str]]:
        """Ordered ``(rel_path, guessed, content digest)`` of every
        recording this run would load: the sha256 of the whole
        BrainVision triplet's bytes, so any content change gives a new
        digest. The provider half of ``io/feature_cache.run_key``."""
        return [(rel_path, guessed, digest)
                for rel_path, guessed, _rec, digest in self._iter_recordings(with_digests=True)]

    def _channel_indices(self, header: brainvision.Header) -> List[int]:
        """Channel resolution with the reference's stale-index reuse: a
        file missing a channel reuses the index of the previous file
        (OffLineDataProvider.java:49-51,172-183)."""
        indices = []
        for name in self._channel_names:
            idx = header.channel_index(name)
            if idx is None:
                idx = self._last_indices[name]
                logger.warning(
                    "Channel %s not found; reusing stale index %d", name, idx
                )
            self._last_indices[name] = idx
            indices.append(idx)
        return indices

    def channel_indices_for(self, rec: brainvision.Recording) -> List[int]:
        """Resolved channel indices for one recording, with the
        reference's stale-index reuse (:meth:`_channel_indices`)."""
        return self._channel_indices(rec.header)

    def load(self) -> extractor.EpochBatch:
        """Parse the inputs and extract host epochs from every resolvable
        file, in info.txt order with one :class:`BalanceState` across
        files: (n, C, 750) float64 epochs, targets and stimulus indices,
        bit-equal to the JAX package's."""
        balance = BalanceState()
        timings = {"parse": 0.0, "epoch": 0.0}
        batches: List[extractor.EpochBatch] = []
        t0 = time.perf_counter()
        for _rel_path, guessed, rec in self.iter_recordings():
            t1 = time.perf_counter()
            timings["parse"] += t1 - t0
            batches.append(self._process_recording(rec, guessed, balance))
            t0 = time.perf_counter()
            timings["epoch"] += t0 - t1
        self._batch = extractor.EpochBatch.concatenate(batches)
        self.timings = timings
        return self._batch

    def _process_recording(
        self,
        rec: brainvision.Recording,
        guessed: int,
        balance: BalanceState,
    ) -> extractor.EpochBatch:
        channels = rec.read_channels(self.channel_indices_for(rec))
        return extractor.extract_epochs(
            channels, rec.markers, guessed,
            pre=self._pre, post=self._post, balance=balance,
        )

    def load_sliding(self, config) -> extractor.EpochBatch:
        """Sliding-window epochs of every resolvable recording, in info.txt
        order (the seizure workload; ``config`` an
        ``epochs.sliding.SlidingConfig``): ``(n, n_channels, window)``
        float64 windows labeled from each recording's ``Seizure`` interval
        annotations, bit-equal to the JAX package's. The manifest's guessed
        numbers are ignored and there is no balance scan."""
        timings = {"parse": 0.0, "epoch": 0.0}
        batches: List[extractor.EpochBatch] = []
        t0 = time.perf_counter()
        for _rel_path, _guessed, rec in self.iter_recordings():
            t1 = time.perf_counter()
            timings["parse"] += t1 - t0
            batches.append(self.sliding_batch_for(rec, config))
            t0 = time.perf_counter()
            timings["epoch"] += t0 - t1
        self._batch = extractor.EpochBatch.concatenate(batches)
        self.timings = timings
        return self._batch

    def sliding_batch_for(self, rec: brainvision.Recording, config) -> extractor.EpochBatch:
        """One recording's sliding-window batch (scaled float64 channels ->
        ``epochs/sliding.py``); the serving path cuts its windows here
        too, so they are the batch run's."""
        from ..epochs import sliding

        channels = rec.read_channels(self.channel_indices_for(rec))
        return sliding.extract_sliding_epochs(channels, rec.markers, config)

    # -- reference-parity accessors ------------------------------------

    @property
    def batch(self) -> extractor.EpochBatch:
        """The last :meth:`load`'s epochs, loading them first if needed."""
        if self._batch is None:
            return self.load()
        return self._batch

    def get_data(self) -> List[np.ndarray]:
        """List of (3, 750) float64 epochs (reference ``getData``)."""
        return [e for e in self.batch.epochs]

    def get_data_labels(self) -> List[float]:
        """List of 0.0/1.0 labels (reference ``getDataLabels``)."""
        return [float(t) for t in self.batch.targets]

    def load_features_device(
        self,
        wavelet_index: int = 8,
        epoch_size: int = 512,
        skip_samples: int = 175,
        feature_size: int = 16,
        backend: str = "decode",
        precision: str = "f32",
        recordings: Optional[Sequence[Tuple[str, int, brainvision.Recording]]] = None,
        overlap: Optional[bool] = None,
        mesh=None,
        mesh_axis: Optional[str] = None,
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """info.txt run -> DWT features without host epochs.

        Per recording, in info.txt order with one shared
        :class:`BalanceState` (:func:`featurize_one` below): the raw
        channels (int16, or scaled float32 for other binary formats) are
        staged to the device once, the host plans the kept markers, and
        one launch of the fused kernel (``ops/ingest_cuda.py``) produces
        the L2-normalized feature rows. Returns (features (n, C*K) float32
        on the provider's device, targets (n,) float64).

        ``backend`` takes the JAX package's fused rung names
        (``decode``, ``pallas``, ``block``, ``xla``) so its call sites
        port unchanged; every one of them runs the CUDA kernel.
        ``precision`` (one of ``decode_ingest.PRECISIONS``) picks the
        kernel's rung; as in the JAX package, a non-f32 rung rides the
        decode backend only. ``recordings``: the run's already parsed
        ``(rel_path, guessed, recording)`` triplets (the builder parses
        them first for the feature cache's key), else
        :meth:`iter_recordings` reads them.

        ``overlap`` (``None``: ``EEG_TPU_OVERLAP``) runs
        :func:`featurize_one` on ``io/staging.prefetch``'s producer
        thread, so recording K+1's staging, planning and kernel launch
        overlap the consumer's handling of recording K; on a card the
        producer launches on a stream of its own and hands each
        recording's rows over with an event. The rows, their order and
        the targets are bit-equal to the serial loop's at any prefetch
        depth. ``timings``: ``parse`` is the time spent waiting on the
        recording source, ``stage`` the staging and planning, ``featurize``
        the kernel launches and the final device sync, each measured on
        the thread that does the work. Under overlap the three run at
        once on two or more threads, so their sum exceeds the wall, which
        ``timings["wall"]`` gives.

        ``mesh`` (a ``parallel.mesh.Mesh`` with two or more devices on its
        ingest axis: ``mesh_axis``, else ``time`` when the mesh has one,
        else its last axis) splits each INT_16 recording over the axis's
        devices through ``parallel/sharded_ingest.py``: the stream padded
        to the shard grid (validity judged on the true length), one block
        a device with its right neighbour's halo, the kernel once a shard,
        the rows gathered in marker order (``ingest.sharded_recordings``;
        ``ingest.sharded_halo_windows`` counts the windows that read a
        neighbour's halo).
        As in the JAX package, a recording the sharded path cannot express
        (a non-INT_16 stream) takes the unsharded kernel and counts
        ``ingest.sharded_fallback``; the route is decided from the
        recording's header before anything is launched. The sharded path
        computes f32 rows, as the JAX package's does. A one-device axis
        is the unsharded path.
        """
        if backend not in FUSED_BACKENDS:
            raise ValueError(f"unknown device-ingest backend {backend!r}")
        if precision != "f32" and backend != "decode":
            raise ValueError(
                f"precision={precision!r} is a decode-rung feature; "
                f"backend {backend!r} computes f32"
            )
        # chaos: one fused ingest fails (a kernel error, an OOM); the
        # port has no degradation ladder, so the run fails with it
        chaos.maybe_fire("ingest.fused")
        featurize = ingest_cuda.make_cuda_ingest_featurizer(
            wavelet_index=wavelet_index,
            epoch_size=epoch_size,
            skip_samples=skip_samples,
            feature_size=feature_size,
            pre=self._pre,
            precision=precision,
        )
        balance = BalanceState()
        sharded_extract, n_shards = None, 1
        if mesh is not None:
            from ..parallel import mesh as pmesh, sharded_ingest

            axis = mesh_axis or (pmesh.TIME_AXIS if pmesh.TIME_AXIS in mesh.axis_names
                                 else mesh.axis_names[-1])
            n_shards = int(mesh.shape[axis])
            if n_shards >= 2:
                sharded_extract = sharded_ingest.make_sharded_ingest(
                    mesh, wavelet_index=wavelet_index, epoch_size=epoch_size,
                    skip_samples=skip_samples, feature_size=feature_size, pre=self._pre,
                    axis=axis,
                )
        timings = {"parse": 0.0, "stage": 0.0, "featurize": 0.0}
        t_start = time.perf_counter()

        def timed(source):
            """``source``, its waits counted as parse time."""
            t0 = time.perf_counter()
            for item in source:
                timings["parse"] += time.perf_counter() - t0
                yield item
                t0 = time.perf_counter()

        def featurize_one(item):
            """One recording: stage, plan, launch -> (kept rows on the
            device, targets). Shared by the serial loop and the overlap
            producer; either way it runs on one thread in info.txt order
            (the balance scan and the stale channel-index reuse are
            order-dependent)."""
            _rel_path, guessed, rec = item
            if sharded_extract is not None:
                if rec.header.binary_format == "INT_16":
                    return featurize_sharded(guessed, rec)
                logger.warning("sharded ingest stages raw int16 streams; %s is %s: the "
                               "unsharded kernel featurizes it", _rel_path,
                               rec.header.binary_format)
                obs.metrics.count("ingest.sharded_fallback")
            t1 = time.perf_counter()
            raw, res, n_samples = device_ingest.stage_raw(
                rec, self.channel_indices_for(rec), self.device
            )
            plan = device_ingest.plan_ingest(
                rec.markers, guessed, n_samples,
                pre=self._pre, post=self._post, balance=balance,
            )
            t2 = time.perf_counter()
            timings["stage"] += t2 - t1
            out = featurize(raw, res, plan.positions, plan.mask)
            timings["featurize"] += time.perf_counter() - t2
            return out[: plan.n_kept], plan.targets  # kept rows lead the plan

        def featurize_sharded(guessed, rec):
            """One INT_16 recording through the sharded ingest: the stream
            padded to the shard grid, planned (validity on the true
            length), split over the devices, the kernel once a shard ->
            (kept rows on the mesh's first device, targets)."""
            from ..parallel import sharded_ingest

            t1 = time.perf_counter()
            indices = self.channel_indices_for(rec)
            raw, res = rec.raw_int16(indices), rec.resolutions(indices)
            n_true = raw.shape[1]
            block = sharded_ingest.shard_block_for(n_true, n_shards)
            raw = np.pad(raw, ((0, 0), (0, n_shards * block - n_true)))
            plan = sharded_ingest.plan_sharded_ingest(
                rec.markers, guessed, raw.shape[1], n_shards, block, pre=self._pre,
                balance=balance, valid_n_samples=n_true,
            )
            staged = sharded_ingest.stage_recording_local_int16(raw, mesh, axis)
            t2 = time.perf_counter()
            timings["stage"] += t2 - t1
            rows = sharded_extract(staged, res, plan).to(self.device)
            timings["featurize"] += time.perf_counter() - t2
            obs.metrics.count("ingest.sharded_recordings")
            obs.metrics.count("ingest.sharded_halo_windows",
                              plan.halo_windows(self._pre + skip_samples + epoch_size))
            return rows, plan.targets

        source = timed(self.iter_recordings() if recordings is None else iter(recordings))
        use_overlap = default_overlap() if overlap is None else bool(overlap)
        if use_overlap:
            obs.metrics.count("ingest.overlap_runs")
            results = list(staging.prefetch(source, device=self.device,
                                            stage_fn=featurize_one))
        else:
            results = [featurize_one(item) for item in source]
        n_feat = len(self._channel_names) * feature_size
        t2 = time.perf_counter()
        if results:
            features = torch.cat([rows for rows, _ in results])
            target_arr = np.concatenate([t for _, t in results])
        else:
            features = torch.zeros((0, n_feat), dtype=torch.float32, device=self.device)
            target_arr = np.zeros((0,), dtype=np.float64)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings["featurize"] += time.perf_counter() - t2
        if use_overlap:
            timings["wall"] = time.perf_counter() - t_start
        self.timings = timings
        return features, target_arr

    def precision_gate_check(
        self,
        recordings: Sequence[Tuple[str, int, brainvision.Recording]],
        wavelet_index: int = 8,
        precision: str = "bf16",
        max_rows: int = 64,
        content_key: Optional[str] = None,
    ) -> dict:
        """The per-run precision accuracy gate (bf16, int8 and int4 share
        it): the first recording's first ``max_rows`` kept markers are
        featurized by the fused kernel in both the requested precision
        and f32 (one launch each on the card), and the rows compared
        against that rung's tolerance
        (``decode_ingest.feature_precision_gate``). The plan uses a fresh
        :class:`BalanceState`: the gate compares feature values of the
        same windows, and the run's own balance scan must not move.

        Returns the gate record with ``gate_seconds`` (the double
        featurize, so a report can tell gate overhead from steady
        state) and ``cached``. ``content_key`` (the first recording's
        content digest) memoizes the decision, which is a function of
        the bytes, the geometry and the tolerance: a re-gating of the
        same content replays the record with ``cached: True`` and
        ``gate_seconds`` 0.0, and launches nothing.
        """
        tol = decode_ingest.precision_gate_tolerance(precision)
        memo_key = None
        if content_key is not None:
            memo_key = (str(content_key), int(wavelet_index), str(precision), int(max_rows),
                        float(tol), self._pre, self._post, tuple(self._channel_names))
            cached = _gate_memo_get(memo_key)
            if cached is not None:
                record = dict(cached)
                record["cached"] = True
                record["gate_seconds"] = 0.0
                return record
        t0 = time.perf_counter()
        if not recordings:
            gate = decode_ingest.feature_precision_gate(
                np.zeros((0, 1), np.float32), np.zeros((0, 1), np.float32),
                precision=precision,
            )
        else:
            _rel, guessed, rec = recordings[0]
            raw, res, n_samples = device_ingest.stage_raw(
                rec, self.channel_indices_for(rec), self.device
            )
            plan = device_ingest.plan_ingest(
                rec.markers, guessed, n_samples, pre=self._pre, post=self._post,
            )
            cap = min(max_rows, plan.capacity)
            positions, mask = plan.positions[:cap], plan.mask[:cap]
            n_real = int(mask.sum())  # the kept rows lead the plan
            rows = {}
            for p in ("f32", precision):
                featurize = ingest_cuda.make_cuda_ingest_featurizer(
                    wavelet_index=wavelet_index, pre=self._pre, precision=p,
                )
                rows[p] = featurize(raw, res, positions, mask)[:n_real]
            gate = decode_ingest.feature_precision_gate(
                rows[precision], rows["f32"], precision=precision,
            )
        gate["gate_seconds"] = round(time.perf_counter() - t0, 6)
        gate["cached"] = False
        if memo_key is not None:
            _gate_memo_put(memo_key, gate)
        return gate
