"""Query-string pipeline front end (reference: Pipeline/PipelineBuilder.java).

The reference's run-time configuration surface is one ``k=v&k=v`` string
(PipelineBuilder.java:94-295). This builder runs its batch P300 path on
the port: ``fe=dwt-<i>-fused`` ingest on the device (the CUDA fused
kernel), the seed-1 shuffle + 70/30 split, linear classifiers with
MLlib-SGD semantics, ``config_*`` pass-through, ``save_clf``/``load_clf``
and the ``result_path`` report file.

Every fused spelling of the JAX package (``-fused`` and
``-fused-decode|-pallas|-block|-xla``) parses, and all of them run the
one CUDA kernel. The port has no feature cache and no degradation
ladder: ``cache=`` and ``degrade=`` parse, and a kernel failure raises.
Keys whose paths are not ported yet raise ``ValueError``.
"""

from __future__ import annotations

import logging
import re
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..io import modelfiles, provider
from ..models import registry, stats
from ..utils import java_compat
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

#: query keys whose paths the port does not run yet (see ROADMAP.md)
NOT_PORTED_KEYS = (
    "classifiers", "overlap", "devices", "mesh_axes", "processes",
    "coordinator", "process_id", "serve", "cv", "cv_mode", "seeds",
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


def _check_ported(query_map: Dict[str, str]) -> None:
    for key in NOT_PORTED_KEYS:
        if key in query_map:
            raise ValueError(f"{key}= is not yet ported; see ROADMAP.md")
    if query_map.get("precision", "f32") != "f32":
        raise ValueError(
            f"precision={query_map['precision']} is not yet ported; see ROADMAP.md"
        )
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
        #: wall seconds of the last run by stage: parse, stage,
        #: featurize, train, test (each device stage ends in a sync)
        self.timers: Dict[str, float] = {}
        #: the last run's feature rows (on ``device``) and targets
        self.features: Optional[torch.Tensor] = None
        self.targets: Optional[np.ndarray] = None
        #: the last run's classifier and the row indices it was tested on
        self.classifier = None
        self.test_index: Optional[list] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def execute(self) -> stats.ClassificationStatistics:
        query_map = get_query_map(self.query)
        _check_ported(query_map)

        # 1. input (PipelineBuilder.java:104-113)
        if "info_file" in query_map:
            files = [query_map["info_file"]]
        elif "eeg_file" in query_map and "guessed_num" in query_map:
            files = [query_map["eeg_file"], query_map["guessed_num"]]
        else:
            raise ValueError("Missing the input file argument")

        # 2. feature extraction (PipelineBuilder.java:128-139)
        if "fe" not in query_map:
            raise ValueError("Missing the feature extraction argument")
        fused = _FUSED_FE.fullmatch(query_map["fe"])
        if fused is None:
            raise ValueError(
                f"fe={query_map['fe']} is not yet ported (the port runs "
                "fe=dwt-<i>-fused); see ROADMAP.md"
            )
        if "train_clf" not in query_map and "load_clf" not in query_map:
            raise ValueError("Missing classifier argument")
        wavelet_index = int(fused.group(1))
        suffix = fused.group(2)
        backend = "decode" if suffix is None else suffix[1:]
        logger.info(
            "fe=%s: fused rung %r runs the CUDA fused-ingest kernel on %s "
            "(no feature cache, no degradation ladder)",
            query_map["fe"], backend, self.device,
        )

        odp = provider.OfflineDataProvider(files, device=self.device)
        features, targets = odp.load_features_device(
            wavelet_index=wavelet_index, backend=backend
        )
        self.timers = dict(odp.timings)
        self.features, self.targets = features, targets
        n = len(targets)
        labels = torch.as_tensor(targets, dtype=torch.float32, device=self.device)

        # 3. classifier (PipelineBuilder.java:151-284)
        if "train_clf" in query_map:
            name = query_map["train_clf"]
            classifier = registry.create(name)
            train_idx, test_idx = java_compat.train_test_split_indices(n, seed=1)
            classifier.set_config(
                {k: v for k, v in query_map.items() if k.startswith("config_")}
            )
            train = torch.as_tensor(train_idx, dtype=torch.long, device=self.device)
            t0 = time.perf_counter()
            classifier.fit(features[train], labels[train])
            self._sync()
            self.timers["train"] = time.perf_counter() - t0
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
            classifier.load(query_map["load_name"])

        test = torch.as_tensor(test_idx, dtype=torch.long, device=self.device)
        t0 = time.perf_counter()
        statistics = classifier.test_features(
            features[test], targets[np.asarray(test_idx, dtype=np.int64)]
        )
        self.timers["test"] = time.perf_counter() - t0
        self.classifier, self.test_index = classifier, list(test_idx)
        return self._finish_run(statistics, query_map)

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
