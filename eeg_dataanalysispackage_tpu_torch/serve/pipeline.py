"""``serve=true`` pipeline mode: drive a session through the service.

Port of the JAX package's ``serve/pipeline.py`` (``run_serve``). The
batch pipeline's ``load_clf=`` mode answers "how does this saved model
score this session" with one fused featurization; this mode answers the
same question through the online path — every kept epoch becomes one
request (the raw window bytes: int16 for INT_16 recordings, scaled
float32 for IEEE_FLOAT_32 and INT_32 ones) submitted to a resident
:class:`serve.service.InferenceService`, micro-batched,
deadline-bounded and admission-controlled. The statistics are the batch
``load_clf=`` run's on the same inputs.

Query surface::

    serve=true&load_clf=logreg&load_name=/models/p300
        &fe=dwt-8-fused&info_file=...
        [&serve_deadline_ms=2000] [&serve_batch=64] [&serve_queue=256]
        [&serve_flush_us=0] [&serve_threshold=<margin>]
        [&precision=f32|bf16|int8|int4]
        [&adapt=true [&swap_gate=off|cost[:<ratio>]] [&drift_window=64]
         [&adapt_batch=16] [&adapt_iters=20] [&checkpoint_path=<dir>]]

``adapt=true`` attaches the model lifecycle (serve/lifecycle.py): after
the session's predictions were served, every served window's true
target is fed back (stage ``adapt``), so the run's statistics are those
of the plain serve run while the adapter trains, scores and may promote
a candidate for the next session.

``serve_tenant_quota=<n>`` sets the per-tenant admission budget of a
multi-tenant service (serve/multiplex.py), whose tenant registry
:func:`parse_tenant_spec` and :func:`load_tenants` read from a
``name=classifier@path,...`` spec.

``task=seizure&serve=true`` (:func:`run_serve_seizure`) streams a
continuous session's sliding windows through the service in its
host-extractor mode; its statistics are the batch ``task=seizure&
load_clf=`` run's.
"""

from __future__ import annotations

import logging
import os
import re

import numpy as np

from . import engine as engine_mod
from . import lifecycle as lifecycle_mod
from . import service as service_mod
from ..epochs.extractor import BalanceState
from ..models import linear as linear_mod
from ..models import population
from ..models import registry as clf_registry
from ..models import seizure
from ..models import stats
from ..ops import decode_ingest
from ..utils import java_compat

logger = logging.getLogger(__name__)

def _conflicting_keys(query_map) -> list:
    """Keys that actually ENABLE a conflicting mode, judged as the batch
    path judges them, so an explicit no-op like ``elastic=false`` or
    ``cv=1`` does not reject the run."""
    conflicts = [k for k in ("train_clf", "classifiers") if k in query_map]
    for flag in ("save_clf", "elastic"):
        if query_map.get(flag) == "true":
            conflicts.append(flag)
    if population.PopulationSpec.from_query_map(query_map).active:
        conflicts.append("cv=/seeds=/sweep=")
    return conflicts


def check_conflicts(query_map) -> None:
    """Raise the reference's message when serve=true is combined with a
    training or population mode (the lifecycle knobs' grammar is the
    plan parser's, ``pipeline/plan.py``)."""
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
    tenant_quota = _int_knob(query_map, "serve_tenant_quota", 0)
    return service_mod.ServeConfig(
        max_batch=_int_knob(query_map, "serve_batch", 64),
        queue_depth=_int_knob(query_map, "serve_queue", 256),
        flush_us=_int_knob(query_map, "serve_flush_us", default_flush_us()),
        # 0 or absent: no per-tenant budget (a single-model service has none)
        tenant_quota=tenant_quota if tenant_quota > 0 else None,
        default_deadline_s=_int_knob(query_map, "serve_deadline_ms", 2000) / 1000.0,
        slo_latency_ms=_float_knob(query_map, "serve_slo_ms", 50.0),
        slo_availability_target=_float_knob(
            query_map, "serve_slo_availability", 0.999
        ),
    )


def parse_tenant_spec(spec: str) -> dict:
    """A multi-tenant model spec -> ``{tenant: (classifier, path)}``.

    The spec is the operator's one-line tenant registry,
    ``name=classifier@path`` entries joined by commas::

        alice=logreg@/models/alice,bob=logreg@/models/bob

    Order is kept (the first tenant anchors the engine's geometry). A
    malformed entry raises ``ValueError`` naming it: a registry is
    served whole or not at all."""
    tenants = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, rest = entry.partition("=")
        classifier_name, sep2, path = rest.partition("@")
        if not (name.strip() and sep and classifier_name.strip()
                and sep2 and path.strip()):
            raise ValueError(
                f"malformed tenant entry {entry!r}; expected "
                f"name=classifier@path"
            )
        name = name.strip()
        if name in tenants:
            raise ValueError(f"duplicate tenant {name!r} in spec")
        tenants[name] = (classifier_name.strip(), path.strip())
    if not tenants:
        raise ValueError(
            "tenant spec is empty; expected name=classifier@path[,...]"
        )
    return tenants


def load_tenants(spec: str) -> dict:
    """Load every tenant of :func:`parse_tenant_spec` into ``{tenant:
    classifier}``, each model once: the registry a
    :class:`serve.multiplex.MultiplexedService` (or a running one's
    ``add_tenant``) is built from."""
    loaded = {}
    for name, (classifier_name, path) in parse_tenant_spec(spec).items():
        classifier = clf_registry.create(classifier_name)
        classifier.load(path)
        loaded[name] = classifier
    return loaded


def lifecycle_config_from_query(query_map, cost_fp: float = 1.0, cost_fn: float = 1.0):
    """The ``adapt=`` family -> a :class:`serve.lifecycle.LifecycleConfig`,
    or None when the run did not ask for ``adapt=true``."""
    if query_map.get("adapt") != "true":
        return None
    return lifecycle_mod.LifecycleConfig.from_query_map(
        query_map, cost_fp=cost_fp, cost_fn=cost_fn
    )


def _adapt_feedback(service, stage, requests, targets_arr) -> None:
    """Feed every served window's true target to the lifecycle manager,
    in submission order, then flush the adapter: partial-fit chunks,
    shadow scoring, gate decisions and any promotion happen here, after
    the session's own predictions were served, so the run's statistics
    are untouched by its own adaptation."""
    if service.lifecycle is None or not requests:
        return
    with stage("adapt"):
        for (window, resolutions), label in zip(requests, targets_arr):
            service.feedback(window, resolutions, float(label))
        service.lifecycle.flush(timeout_s=service.config.drain_timeout_s)


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


def _check_serve_keys(query_map) -> None:
    """The conflict rules, then ``load_clf=`` and ``load_name=``: a
    serve run serves a saved model."""
    check_conflicts(query_map)
    if "load_clf" not in query_map:
        raise ValueError(
            "serve=true requires load_clf= (the model to serve)"
        )
    if "load_name" not in query_map:
        raise ValueError("Classifier location not provided")


def _load_served_model(query_map):
    """The saved classifier and the ``serve_threshold=`` applied to it
    (None when absent)."""
    classifier = clf_registry.create(query_map["load_clf"])
    classifier.load(query_map["load_name"])
    return classifier, resolve_serve_threshold(query_map, classifier)


def _serve_session(service, stage, requests, targets_arr, threshold, confusion_only,
                   what, **attrs):
    """Every ``(window, resolutions)`` request through ``service`` (started
    here, stopped with a drain): micro-batched, deadline-bounded,
    shed-don't-stall; with ``adapt=true`` the session's labeled outcomes
    then feed the lifecycle manager. The statistics are the batch
    ``load_clf=`` run's way: over the seed-1 shuffled order. Returns
    ``(ClassificationStatistics, serve block)``."""
    n = len(requests)
    service.start()  # builds and checks the kernels before traffic
    try:
        with stage("serve", **attrs):
            results = []
            if n:
                results = service.predict_all(
                    [r[0] for r in requests], [r[1] for r in requests]
                )
        _adapt_feedback(service, stage, requests, targets_arr)
    finally:
        drained = service.stop(drain=True)

    predictions = np.array([r.prediction for r in results], dtype=np.float64)
    with stage("test", **attrs):
        perm = java_compat.java_shuffle_indices(n, seed=1)
        statistics = stats.ClassificationStatistics.from_arrays(
            predictions[perm], targets_arr[perm], confusion_only=confusion_only,
        )

    block = service.stats_block()
    block["requests"]["total_epochs"] = n
    block["drained_cleanly"] = drained
    if threshold is not None:
        block["serve_threshold"] = threshold
    logger.info(
        "served %d %s: %d completed, %d shed, %d deadline-"
        "exceeded, %d failed (drained=%s)",
        n, what, block["requests"]["completed"], block["requests"]["shed"],
        block["requests"]["deadline_exceeded"],
        block["requests"]["failed"], drained,
    )
    return statistics, block


def run_serve(query_map, provider_factory, stage, device):
    """Execute one ``serve=true`` run on ``device``.

    ``provider_factory`` builds the run's ``OfflineDataProvider``;
    ``stage(name)`` is the builder's stage-timer context. Returns
    ``(ClassificationStatistics, serve_block)``.
    """
    _check_serve_keys(query_map)
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
    classifier, threshold = _load_served_model(query_map)

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
        lifecycle=lifecycle_config_from_query(query_map),
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

    # 2. serve, 3. statistics
    return _serve_session(service, stage, requests, targets_arr, threshold,
                          classifier.confusion_only_stats, "epochs")


def run_serve_seizure(query_map, provider_factory, stage, device):
    """``task=seizure&serve=true`` on ``device``: the session's sliding
    windows, each one request through the resident service.

    The engine runs in its host-extractor mode (``serve/engine.py``,
    ``pre=0``, ``post=window``): every batch takes the featurize-and-
    predict path of the batch ``task=seizure&load_clf=`` run, on the same
    float64 scaled windows (``provider.sliding_batch_for``) shipped with
    unit resolutions, so the served statistics equal the batch run's. A
    ``-pallas`` ``fe=`` launches the epoch-features kernel once a batch.
    ``serve_threshold=`` re-thresholds the linear margin (statistics then
    differ from the batch run's on purpose); ``adapt=true`` judges on the
    run's ``cost_fp=``/``cost_fn=``.

    Returns ``(ClassificationStatistics, serve block, workload block)``.
    """
    from ..features import registry as fe_registry

    _check_serve_keys(query_map)
    fe_value = query_map.get("fe", "")
    if not fe_value:
        raise ValueError("Missing the feature extraction argument")
    if "-fused" in fe_value:
        raise ValueError(
            "task=seizure serves host-extracted features; fe= must be "
            "a registry form, not a -fused mode"
        )
    slide_cfg = seizure.sliding_config(query_map)
    fe = fe_registry.create(fe_value, device=device)
    classifier, threshold = _load_served_model(query_map)

    odp = provider_factory()
    service = service_mod.InferenceService(
        classifier,
        n_channels=odp.n_channels,
        pre=0,  # a continuous window has no prestimulus segment
        post=slide_cfg.window,
        config=serve_config_from_query(query_map),
        host_extractor=fe,
        device=device,
        # the lifecycle judges on the run's misclassification costs (the
        # explicit knobs; class_weight=balanced sets training weights)
        lifecycle=lifecycle_config_from_query(
            query_map,
            cost_fp=float(query_map.get("cost_fp") or 1.0),
            cost_fn=float(query_map.get("cost_fn") or 1.0),
        ),
    )

    # 1. ingest: the batch run's sliding windows, float64 and scaled, with
    # unit resolutions (scaling by 1.0 is exact)
    requests = []
    targets = []
    unit_res = np.ones(odp.n_channels, dtype=np.float32)
    with stage("ingest", mode="serve", task="seizure"):
        for _rel, _guessed, rec in odp.iter_recordings():
            batch = odp.sliding_batch_for(rec, slide_cfg)
            requests.extend((w, unit_res) for w in batch.epochs)
            targets.append(batch.targets)
    targets_arr = np.concatenate(targets) if targets else np.zeros(0, np.float64)

    # 2. serve, 3. statistics with the true confusion matrix (the seizure
    # classifiers' contract) and the extended block
    statistics, block = _serve_session(service, stage, requests, targets_arr, threshold,
                                       False, "seizure windows", task="seizure")
    weights = seizure.seizure_weights(query_map, targets_arr)
    stats.mark_extended(statistics, cost_fp=weights[2], cost_fn=weights[3])
    workload = seizure.workload_record(slide_cfg, targets_arr, weights, fe_value)
    workload["serve_threshold"] = threshold
    return statistics, block, workload
