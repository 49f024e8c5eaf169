"""``serve=true`` pipeline mode: drive a session through the service.

Port of the JAX package's ``serve/pipeline.py`` (``run_serve``). The
batch pipeline's ``load_clf=`` mode answers "how does this saved model
score this session" with one fused featurization; this mode answers the
same question through the online path — every kept epoch becomes one
request (raw int16 window bytes) submitted to a resident
:class:`serve.service.InferenceService`, micro-batched,
deadline-bounded and admission-controlled. The statistics are the batch
``load_clf=`` run's on the same inputs.

Query surface::

    serve=true&load_clf=logreg&load_name=/models/p300
        &fe=dwt-8-fused&info_file=...
        [&serve_deadline_ms=2000] [&serve_batch=64] [&serve_queue=256]
        [&serve_flush_us=0] [&serve_threshold=<margin>]
        [&precision=f32|bf16|int8|int4]

Not ported: multi-tenant serving, ``adapt=`` and ``task=seizure``.
"""

from __future__ import annotations

import logging
import os
import re

import numpy as np

from . import engine as engine_mod
from . import service as service_mod
from ..epochs.extractor import BalanceState
from ..models import linear as linear_mod
from ..models import registry as clf_registry
from ..models import stats
from ..ops import decode_ingest
from ..utils import java_compat

logger = logging.getLogger(__name__)

#: query keys of the modes that cannot combine with serve=true; the
#: port has no population mode, so their presence alone conflicts
_POPULATION_KEYS = ("cv", "seeds", "sweep")


def _conflicting_keys(query_map) -> list:
    """Keys that actually ENABLE a conflicting mode, so an explicit
    no-op like ``save_clf=false`` does not reject the run."""
    conflicts = [k for k in ("train_clf", "classifiers") if k in query_map]
    for flag in ("save_clf", "elastic"):
        if query_map.get(flag) == "true":
            conflicts.append(flag)
    if any(k in query_map for k in _POPULATION_KEYS):
        conflicts.append("cv=/seeds=/sweep=")
    return conflicts


def check_conflicts(query_map) -> None:
    """Raise the reference's message when serve=true is combined with a
    training or population mode."""
    conflicts = _conflicting_keys(query_map)
    if conflicts:
        raise ValueError(
            f"serve=true is an inference mode; it cannot combine "
            f"with {', '.join(conflicts)}"
        )


def _int_knob(query_map, name: str, default: int) -> int:
    value = query_map.get(name, "")
    if not value:
        return default
    try:
        return int(value)
    except ValueError:
        raise ValueError(
            f"query parameter {name}= must be an integer, got {value!r}"
        )


def _float_knob(query_map, name: str, default: float) -> float:
    value = query_map.get(name, "")
    if not value:
        return default
    try:
        return float(value)
    except ValueError:
        raise ValueError(
            f"query parameter {name}= must be a number, got {value!r}"
        )


#: process default for the bounded batch-fill window (microseconds);
#: a per-run ``serve_flush_us=`` query value wins.
ENV_SERVE_FLUSH_US = "EEG_TPU_SERVE_FLUSH_US"


def default_flush_us() -> int:
    raw = os.environ.get(ENV_SERVE_FLUSH_US, "")
    if not raw:
        return 0
    try:
        return int(raw)
    except ValueError:
        logger.warning(
            "%s=%r is not an integer; using 0 (no flush window)",
            ENV_SERVE_FLUSH_US, raw,
        )
        return 0


def serve_config_from_query(query_map) -> service_mod.ServeConfig:
    return service_mod.ServeConfig(
        max_batch=_int_knob(query_map, "serve_batch", 64),
        queue_depth=_int_knob(query_map, "serve_queue", 256),
        flush_us=_int_knob(query_map, "serve_flush_us", default_flush_us()),
        default_deadline_s=_int_knob(query_map, "serve_deadline_ms", 2000) / 1000.0,
        slo_latency_ms=_float_knob(query_map, "serve_slo_ms", 50.0),
        slo_availability_target=_float_knob(
            query_map, "serve_slo_availability", 0.999
        ),
    )


def resolve_serve_threshold(query_map, classifier):
    """``serve_threshold=<margin>``: the recall-tuning decision knob,
    applied to the loaded linear model's margin threshold. Returns the
    float applied, or None when the knob is absent."""
    value = query_map.get("serve_threshold", "")
    if not value:
        return None
    try:
        threshold = float(value)
    except ValueError:
        raise ValueError(
            f"serve_threshold= must be a float margin, got {value!r}"
        )
    if not isinstance(classifier, linear_mod._LinearClassifier):
        raise ValueError(
            "serve_threshold= re-thresholds a linear margin; "
            f"{type(classifier).__name__} has none"
        )
    classifier.margin_threshold = threshold
    return threshold


def run_serve(query_map, provider_factory, stage, device):
    """Execute one ``serve=true`` run on ``device``.

    ``provider_factory`` builds the run's ``OfflineDataProvider``;
    ``stage(name)`` is the builder's stage-timer context. Returns
    ``(ClassificationStatistics, serve_block)``.
    """
    check_conflicts(query_map)
    if "load_clf" not in query_map:
        raise ValueError(
            "serve=true requires load_clf= (the model to serve)"
        )
    if "load_name" not in query_map:
        raise ValueError("Classifier location not provided")
    fused_match = re.fullmatch(
        r"dwt-(\d+)-fused(-pallas|-block|-xla|-decode)?",
        query_map.get("fe", ""),
    )
    if fused_match is None:
        raise ValueError(
            "serve=true runs the fused bytes->features->predict "
            "program; fe= must be a dwt-<i>-fused form"
        )
    wavelet_index = int(fused_match.group(1))
    # precision=bf16|int8|int4 serve through the reduced-precision rung
    # behind the engine's warmup accuracy gate; the decision is the serve
    # block's ``precision`` entry
    precision = decode_ingest.requested_precision(query_map)

    classifier = clf_registry.create(query_map["load_clf"])
    classifier.load(query_map["load_name"])
    threshold = resolve_serve_threshold(query_map, classifier)

    odp = provider_factory()
    service = service_mod.InferenceService(
        classifier,
        wavelet_index=wavelet_index,
        n_channels=odp.n_channels,
        pre=odp.pre,
        post=odp.post,
        config=serve_config_from_query(query_map),
        precision=precision,
        device=device,
    )

    # 1. ingest: parse the session into per-epoch raw windows; the
    # shared BalanceState keeps cross-file retention identical to batch
    balance = BalanceState()
    requests = []  # (window, resolutions)
    targets = []
    with stage("ingest"):
        for _rel, guessed, rec in odp.iter_recordings():
            windows, rec_targets, resolutions = engine_mod.windows_from_recording(
                rec, odp.channel_indices_for(rec), guessed,
                pre=odp.pre, post=odp.post, balance=balance,
            )
            requests.extend((w, resolutions) for w in windows)
            targets.append(rec_targets)
    targets_arr = np.concatenate(targets) if targets else np.zeros(0, np.float64)
    n = len(requests)

    # 2. serve: every epoch as an online request — micro-batched,
    # deadline-bounded, shed-don't-stall
    service.start()  # builds and checks the kernels before traffic
    try:
        with stage("serve"):
            results = []
            if n:
                results = service.predict_all(
                    [r[0] for r in requests], [r[1] for r in requests]
                )
    finally:
        drained = service.stop(drain=True)

    predictions = np.array([r.prediction for r in results], dtype=np.float64)

    # 3. statistics, the load_clf= way: evaluated over the seed-1
    # shuffled order
    with stage("test"):
        perm = java_compat.java_shuffle_indices(n, seed=1)
        statistics = stats.ClassificationStatistics.from_arrays(
            predictions[perm], targets_arr[perm],
            confusion_only=classifier.confusion_only_stats,
        )

    block = service.stats_block()
    block["requests"]["total_epochs"] = n
    block["drained_cleanly"] = drained
    if threshold is not None:
        block["serve_threshold"] = threshold
    logger.info(
        "served %d epochs: %d completed, %d shed, %d deadline-"
        "exceeded, %d failed (drained=%s)",
        n, block["requests"]["completed"], block["requests"]["shed"],
        block["requests"]["deadline_exceeded"],
        block["requests"]["failed"], drained,
    )
    return statistics, block
