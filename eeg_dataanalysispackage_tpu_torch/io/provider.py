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
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import brainvision, remote, sources
from .. import obs
from ..epochs import extractor
from ..epochs.extractor import BalanceState
from ..obs import chaos
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
    goes through; ``None`` routes by the first argument's URI scheme."""

    def __init__(
        self,
        args: Sequence[str],
        filesystem: Optional[sources.FileSystem] = None,
        channel_names: Sequence[str] = constants.CHANNEL_NAMES,
        pre: int = constants.PRESTIMULUS_SAMPLES,
        post: int = constants.POSTSTIMULUS_SAMPLES,
        device: Optional[Union[str, torch.device]] = None,
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
        self._last_indices: Dict[str, int] = {c: 0 for c in self._channel_names}
        self._batch: Optional[extractor.EpochBatch] = None
        #: wall seconds of the last load (parse, epoch) or
        #: load_features_device (parse, stage, featurize; featurize
        #: ends in a device sync), by stage
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

    def _iter_recordings(
        self, with_digests: bool = False,
    ) -> Iterator[Tuple[str, int, brainvision.Recording, Optional[str]]]:
        """``(rel_path, guessed, recording, digest)`` in info.txt order:
        one read per file of each triplet (counted in
        ``ingest.file_reads``); ``digest`` is the sha256 of the triplet's
        bytes (.vhdr, .vmrk, .eeg) with ``with_digests``, else None."""
        prefix, files = self._resolve_files()
        for rel_path, guessed in files.items():
            try:
                blobs = self._read_triplet(prefix + rel_path)
            except FileNotFoundError as e:
                logger.warning("Did not load %s: %s", rel_path, e)
                continue
            digest = None
            if with_digests:
                h = hashlib.sha256()
                for blob in blobs:
                    h.update(blob)
                digest = h.hexdigest()
            yield rel_path, guessed, brainvision.load_recording_bytes(*blobs), digest

    def _read_triplet(self, eeg_path: str) -> List[bytes]:
        """The .vhdr, .vmrk and .eeg bytes of one recording, one read
        each (``FileNotFoundError`` when a sibling is missing, as
        ``setFileNames`` finds, OffLineDataProvider.java:327-365)."""
        base = os.path.splitext(eeg_path)[0]
        triplet = (base + ".vhdr", base + ".vmrk", eeg_path)
        for p in triplet:
            if not self._fs.exists(p):
                raise FileNotFoundError(f"No related file found: {p}")
        blobs = [self._fs.read_bytes(p) for p in triplet]
        obs.metrics.count("ingest.file_reads", 3)
        return blobs

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
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """info.txt run -> DWT features without host epochs.

        Per recording, in info.txt order with one shared
        :class:`BalanceState`: the raw channels (int16, or scaled float32
        for other binary formats) are staged to the device once, the host
        plans the kept markers, and one launch of
        the fused kernel (``ops/ingest_cuda.py``) produces the
        L2-normalized feature rows. Returns (features (n, C*K) float32
        on the provider's device, targets (n,) float64).

        ``backend`` takes the JAX package's fused rung names
        (``decode``, ``pallas``, ``block``, ``xla``) so its call sites
        port unchanged; every one of them runs the CUDA kernel.
        ``precision`` (one of ``decode_ingest.PRECISIONS``) picks the
        kernel's rung; as in the JAX package, a non-f32 rung rides the
        decode backend only. ``recordings``: the run's already parsed
        ``(rel_path, guessed, recording)`` triplets (the builder parses
        them first when a precision gate needs the first one), else
        :meth:`iter_recordings` reads them.
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
        timings = {"parse": 0.0, "stage": 0.0, "featurize": 0.0}
        rows: List[torch.Tensor] = []
        targets: List[np.ndarray] = []
        t0 = time.perf_counter()
        source = self.iter_recordings() if recordings is None else iter(recordings)
        for _rel_path, guessed, rec in source:
            t1 = time.perf_counter()
            timings["parse"] += t1 - t0
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
            rows.append(out[: plan.n_kept])  # kept rows lead the plan
            targets.append(plan.targets)
            t0 = time.perf_counter()
            timings["featurize"] += t0 - t2
        n_feat = len(self._channel_names) * feature_size
        t2 = time.perf_counter()
        if rows:
            features = torch.cat(rows)
            target_arr = np.concatenate(targets)
        else:
            features = torch.zeros((0, n_feat), dtype=torch.float32, device=self.device)
            target_arr = np.zeros((0,), dtype=np.float64)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings["featurize"] += time.perf_counter() - t2
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
