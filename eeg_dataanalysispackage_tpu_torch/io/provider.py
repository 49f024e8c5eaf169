"""Offline data provider: info.txt / .eeg inputs -> epochs or features.

Port of the JAX package's ``io/provider.OfflineDataProvider`` for one
device: :meth:`OfflineDataProvider.load` gives host epochs (the ``fe=``
path), :meth:`OfflineDataProvider.load_features_device` gives fused
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
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import brainvision
from ..epochs import extractor
from ..epochs.extractor import BalanceState
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


def parse_info_txt(text: str) -> Dict[str, int]:
    """``info.txt`` -> ordered {relative .eeg path: guessed number}."""
    files: Dict[str, int] = {}
    for line in text.splitlines():
        if len(line) == 0 or line[0] == "#":
            continue
        # Java's String.split(" ") discards trailing empty strings, so
        # 'path ' (trailing space) parses as a single-field line and is
        # silently skipped (OffLineDataProvider.java:302-305).
        parts = line.split(" ")
        while parts and parts[-1] == "":
            parts.pop()
        if len(parts) > 1:
            try:
                num = int(parts[1])
            except ValueError as e:
                raise ValueError(
                    f"Line {line!r} contains an improper number format"
                ) from e
            files[parts[0]] = num
    return files


class OfflineDataProvider:
    """Loads BrainVision recordings into balanced P300 epochs on the host
    (:meth:`load`) or featurizes them on ``device``
    (:meth:`load_features_device`; ``None`` -> ``cuda``, raises without
    a card)."""

    def __init__(
        self,
        args: Sequence[str],
        channel_names: Sequence[str] = constants.CHANNEL_NAMES,
        pre: int = constants.PRESTIMULUS_SAMPLES,
        post: int = constants.POSTSTIMULUS_SAMPLES,
        device: Optional[Union[str, torch.device]] = None,
    ):
        args = [a for a in args if a is not None]
        if len(args) == 0 or len(args) > 6:
            raise ValueError(_USAGE)
        self._args = list(args)
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
            with open(loc, encoding="utf-8", errors="replace") as f:
                return prefix, parse_info_txt(f.read())
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
        prefix, files = self._resolve_files()
        for rel_path, guessed in files.items():
            eeg_path = prefix + rel_path
            base = os.path.splitext(eeg_path)[0]
            triplet = (base + ".vhdr", base + ".vmrk", eeg_path)
            missing = [p for p in triplet if not os.path.exists(p)]
            if missing:
                logger.warning(
                    "Did not load %s: No related file found: %s",
                    rel_path, missing[0],
                )
                continue
            blobs = []
            for p in triplet:
                with open(p, "rb") as f:
                    blobs.append(f.read())
            yield rel_path, guessed, brainvision.load_recording_bytes(*blobs)

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
        state) and ``cached``. ``cached`` is always False: the JAX
        package memoizes the decision per content digest, and the port
        computes no content digests (it has no feature cache yet).
        """
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
        return gate
