"""Query-string pipeline front end (reference: Pipeline/PipelineBuilder.java).

The reference's run-time configuration surface is one ``k=v&k=v`` string
(PipelineBuilder.java:94-295). This builder runs its batch P300 path on
the port, in two forms:

- ``fe=dwt-<i>-fused``: ingest on the device (the CUDA fused kernel),
  no host epochs;
- ``fe=dwt-<i>`` and ``-tpu``, ``-tpu-compact``, ``-pallas``: host epochs
  (``provider.load``), featurized by the ``features/registry`` extractor
  inside ``classifier.train``/``test`` (``-pallas`` runs the CUDA
  epoch-features kernel);

then the seed-1 shuffle + 70/30 split, linear classifiers with MLlib-SGD
semantics, ``config_*`` pass-through, ``save_clf``/``load_clf`` and the
``result_path`` report file. ``serve=true`` drives the session through
the resident inference service (``serve/pipeline.py``).

Every fused spelling of the JAX package (``-fused`` and
``-fused-decode|-pallas|-block|-xla``) parses, and all of them run the
one CUDA kernel. ``precision=bf16|int8|int4`` (or ``EEG_TPU_PRECISION``)
runs the kernel's reduced-precision rung on the bare ``-fused`` and
``-fused-decode`` spellings, behind the JAX package's per-run accuracy
gate: the first recording's first 64 rows in both precisions, and f32
for the whole run above the rung's tolerance (recorded in
:attr:`PipelineBuilder.precision_resolved`). The port has no feature
cache and no degradation ladder: ``cache=`` and ``degrade=`` parse, and
a kernel failure raises. Keys whose paths are not ported yet raise
``ValueError``.
"""

from __future__ import annotations

import contextlib
import logging
import re
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..features import registry as fe_registry
from ..io import modelfiles, provider
from ..models import registry, stats
from ..ops import decode_ingest
from ..serve import pipeline as serve_pipeline
from ..utils import java_compat
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

#: query keys whose paths the port does not run yet (see ROADMAP.md)
NOT_PORTED_KEYS = (
    "classifiers", "overlap", "devices", "mesh_axes", "processes",
    "coordinator", "process_id", "cv", "cv_mode", "seeds",
    "sweep", "population_mode", "fe_sweep", "elastic", "checkpoint_path",
    "faults", "faults_seed", "report", "adapt",
)

_FUSED_FE = re.compile(r"dwt-(\d+)-fused(-pallas|-block|-xla|-decode)?")


def get_query_map(query: str) -> Dict[str, str]:
    """k=v&k=v parse; empty values tolerated (PipelineBuilder.java:49-68).

    Values split at the FIRST ``=`` only, as the JAX package does, so
    option values carrying ``=`` survive.
    """
    out: Dict[str, str] = {}
    for param in query.split("&"):
        name, sep, value = param.partition("=")
        out[name] = value if sep else ""
    return out


def resolve_precision(query_map: Dict[str, str]) -> str:
    """The batch run's feature precision
    (``decode_ingest.requested_precision``); raises the JAX package's
    messages for a non-f32 rung with a non-fused ``fe=`` or with an
    explicit fused backend other than decode."""
    precision = decode_ingest.requested_precision(query_map)
    if precision == "f32":
        return precision
    fused = _FUSED_FE.fullmatch(query_map.get("fe", ""))
    if fused is None:
        raise ValueError(
            f"precision={precision} applies to the fused fe= modes "
            "(fe=dwt-<i>-fused[-decode]); host-path features are "
            "the bit-parity reference and stay f64"
        )
    suffix = fused.group(2)
    if suffix not in (None, "-decode"):
        raise ValueError(
            f"precision={precision} rides the decode rung; it cannot combine "
            f"with the explicit fe=...-fused{suffix} backend"
        )
    return precision


def _check_ported(query_map: Dict[str, str]) -> None:
    for key in NOT_PORTED_KEYS:
        if key in query_map:
            raise ValueError(f"{key}= is not yet ported; see ROADMAP.md")
    if query_map.get("task", "p300") != "p300":
        raise ValueError(f"task={query_map['task']} is not yet ported; see ROADMAP.md")


class PipelineBuilder:
    """``PipelineBuilder(query, device=None).execute()``: ``device=None``
    runs on ``cuda`` and raises without a card."""

    def __init__(
        self, query: str, device: Optional[Union[str, torch.device]] = None
    ):
        self.query = query
        self.device = resolve_device(device)
        self.statistics: Optional[stats.ClassificationStatistics] = None
        #: wall seconds of the last run by stage: parse, stage (fused)
        #: or epoch (host fe=), featurize, train, test (each device
        #: stage ends in a sync)
        self.timers: Dict[str, float] = {}
        #: the last fused run's feature rows (on ``device``); the last
        #: run's targets
        self.features: Optional[torch.Tensor] = None
        self.targets: Optional[np.ndarray] = None
        #: the last host fe= run's epochs and feature extractor
        self.batch = None
        self.fe = None
        #: the last run's classifier and the row indices it was tested on
        self.classifier = None
        self.test_index: Optional[list] = None
        #: the last serve=true run's serve block (service stats)
        self.serve_block: Optional[dict] = None
        #: the last fused run's precision decision, ``{"requested",
        #: "used", "gate"}`` (``used`` is f32 when the gate tripped);
        #: None at f32
        self.precision_resolved: Optional[dict] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Accumulate a stage's wall seconds into :attr:`timers`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name] = self.timers.get(name, 0.0) + time.perf_counter() - t0

    def execute(self) -> stats.ClassificationStatistics:
        query_map = get_query_map(self.query)
        serve = query_map.get("serve")
        if serve == "true":
            # the reference's conflict messages come before any
            # not-yet-ported key of the conflicting modes
            serve_pipeline.check_conflicts(query_map)
        elif serve is not None:
            raise ValueError(f"serve={serve} is not yet ported; see ROADMAP.md")
        _check_ported(query_map)

        # 1. input (PipelineBuilder.java:104-113)
        if "info_file" in query_map:
            files = [query_map["info_file"]]
        elif "eeg_file" in query_map and "guessed_num" in query_map:
            files = [query_map["eeg_file"], query_map["guessed_num"]]
        else:
            raise ValueError("Missing the input file argument")
        self.precision_resolved = None

        # serve=true: the saved classifier loads once and every kept
        # epoch becomes a request through the resident micro-batching
        # service; the statistics are the batch load_clf= run's
        if serve == "true":
            self.timers = {}
            statistics, self.serve_block = serve_pipeline.run_serve(
                query_map,
                lambda: provider.OfflineDataProvider(files, device=self.device),
                self._stage,
                self.device,
            )
            return self._finish_run(statistics, query_map)

        # the JAX package checks precision= before the other arguments
        precision = resolve_precision(query_map)

        # 2. feature extraction (PipelineBuilder.java:128-139)
        if "fe" not in query_map:
            raise ValueError("Missing the feature extraction argument")
        fused = _FUSED_FE.fullmatch(query_map["fe"])
        # an unknown or unported fe= spelling raises here, before loading
        fe = None if fused else fe_registry.create(query_map["fe"], device=self.device)
        if "train_clf" not in query_map and "load_clf" not in query_map:
            raise ValueError("Missing classifier argument")
        odp = provider.OfflineDataProvider(files, device=self.device)
        if fe is None:
            wavelet_index = int(fused.group(1))
            suffix = fused.group(2)
            backend = "decode" if suffix is None else suffix[1:]
            logger.info(
                "fe=%s: fused rung %r runs the CUDA fused-ingest kernel on %s "
                "at precision %s (no feature cache, no degradation ladder)",
                query_map["fe"], backend, self.device, precision,
            )
            recordings, pre_timers = None, {}
            precision_used = precision
            if precision != "f32":
                recordings, pre_timers, precision_used = self._precision_gate(
                    odp, wavelet_index, precision
                )
            features, targets = odp.load_features_device(
                wavelet_index=wavelet_index, backend=backend,
                precision=precision_used, recordings=recordings,
            )
            labels = torch.as_tensor(targets, dtype=torch.float32, device=self.device)
            batch = None
        else:
            # the host fe= path (JAX package: pipeline/builder.py:834-840,
            # 904-990): host epochs; classifier.train and classifier.test
            # each featurize their own rows with fe
            batch = odp.load()
            features, targets = None, batch.targets
        self.timers = dict(odp.timings)
        if fe is None:
            for name, seconds in pre_timers.items():
                self.timers[name] = self.timers.get(name, 0.0) + seconds
        self.features, self.targets, self.batch, self.fe = features, targets, batch, fe
        n = len(targets)

        # 3. classifier (PipelineBuilder.java:151-284)
        if "train_clf" in query_map:
            name = query_map["train_clf"]
            classifier = registry.create(name)
            train_idx, test_idx = java_compat.train_test_split_indices(n, seed=1)
            classifier.set_config(
                {k: v for k, v in query_map.items() if k.startswith("config_")}
            )
            if fe is None:
                train = torch.as_tensor(train_idx, dtype=torch.long, device=self.device)
                t0 = time.perf_counter()
                classifier.fit(features[train], labels[train])
                self._sync()
                self.timers["train"] = time.perf_counter() - t0
            else:
                rows = np.asarray(train_idx, dtype=np.int64)
                classifier.train(batch.epochs[rows], batch.targets[rows], fe)
            logger.info("trained %s", name)
            if query_map.get("save_clf") == "true":
                if "save_name" not in query_map:
                    raise ValueError(
                        "Please provide a location to save a classifier "
                        "within the save_name query parameter"
                    )
                classifier.save(query_map["save_name"])
        else:
            classifier = registry.create(query_map["load_clf"])
            if "load_name" not in query_map:
                raise ValueError("Classifier location not provided")
            # load mode tests on ALL shuffled data — no split
            # (PipelineBuilder.java:261-278)
            test_idx = java_compat.java_shuffle_indices(n, seed=1)
            if fe is not None:
                classifier.set_feature_extraction(fe)
            classifier.load(query_map["load_name"])

        rows = np.asarray(test_idx, dtype=np.int64)
        if fe is None:
            test = torch.as_tensor(rows, dtype=torch.long, device=self.device)
            t0 = time.perf_counter()
            statistics = classifier.test_features(features[test], targets[rows])
            self.timers["test"] = time.perf_counter() - t0
        else:
            statistics = classifier.test(batch.epochs[rows], batch.targets[rows])
            timings = classifier.timings
            self.timers["featurize"] = timings["featurize"]
            if "fit" in timings:
                self.timers["train"] = timings["fit"]
            self.timers["test"] = timings["predict"]
        self.classifier, self.test_index = classifier, list(test_idx)
        return self._finish_run(statistics, query_map)

    def _precision_gate(self, odp, wavelet_index: int, precision: str):
        """Parse the session, then run the per-run accuracy gate on its
        first recording (JAX package: pipeline/builder.py:524-570).
        Returns ``(recordings, {"parse": s, "gate": s}, precision
        used)``; above the rung's tolerance the run computes f32,
        recorded in :attr:`precision_resolved`, never silently."""
        t0 = time.perf_counter()
        recordings = list(odp.iter_recordings())
        t1 = time.perf_counter()
        gate = odp.precision_gate_check(recordings, wavelet_index, precision=precision)
        used = precision
        if not gate["ok"]:
            used = "f32"
            logger.warning(
                "pipeline.%s_gate auto-disable: max abs dev %.3e > gate %.3e; "
                "the run computes f32",
                precision, gate["max_abs_dev"], gate["tolerance"],
            )
        self.precision_resolved = {"requested": precision, "used": used, "gate": gate}
        return recordings, {"parse": t1 - t0, "gate": time.perf_counter() - t1}, used

    def _finish_run(self, statistics, query_map):
        """Logging, the atomic ``result_path`` report, and the hand-off."""
        logger.info("statistics:\n%s", statistics)
        logger.info("stage timings (s): %s", self.timers)
        if "result_path" in query_map:
            # PrintWriter.println parity: a newline after toString()
            modelfiles.atomic_write_bytes(
                query_map["result_path"], (str(statistics) + "\n").encode("utf-8")
            )
        self.statistics = statistics
        return statistics
