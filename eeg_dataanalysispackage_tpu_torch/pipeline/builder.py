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

then the seed-1 shuffle + 70/30 split, the classifiers (logreg and svm
with MLlib-SGD semantics, ``config_mini_batch_fraction`` sampling
included; ``nn``, the neural network of ``models/nn.py``, trained on the
run's device; the trees ``dt``, ``rf``, ``gbt`` of ``models/trees.py``,
grown on the host, and their ``-tpu`` names, grown on the run's device),
``config_*`` pass-through, ``save_clf``/``load_clf`` and
the ``result_path`` report file. The training surface beyond one model:
``classifiers=a,b,…`` trains and tests every named classifier on the one
feature matrix the run made (``models.stats.FanOutStatistics``); the
population axes ``cv=``, ``cv_mode=``, ``seeds=``, ``sweep=`` and
``population_mode=`` expand SGD-family training into a member population
(``models/population.py``, ``models.stats.PopulationStatistics``; its
record is :attr:`PipelineBuilder.population_block`); and
``elastic=true&checkpoint_path=<dir>`` (``save_every=``,
``max_restarts=``) trains through ``fit_elastic``: chunks checkpointed
under the directory, bounded restarts, a divergence sentinel, the
directory cleared when training ends. The JAX package's conflict rules
for these modes raise its messages before any file is read. ``serve=true`` drives the session through
the resident inference service (``serve/pipeline.py``), with
``adapt=true`` its model lifecycle (partial fit on the session's labeled
outcomes, gated hot swap, drift; ``checkpoint_path=`` is the adapter's
resume directory); any other ``serve=`` value runs the batch path, as in
the JAX package.

``task=seizure`` runs the seizure workload: the session's continuous
recordings cut into sliding windows labeled from their ``Seizure``
interval markers (``window=``, ``stride=``, ``label_overlap=``),
featurized on the host by any registry ``fe=`` (the subband grammar
``dwt-<family>:level=<L>[:stats=…]``, or ``fe=dwt-8-pallas`` through the
epoch-features kernel), trained cost-sensitively (``class_weight=``,
``cost_fp=``, ``cost_fn=``) by every route above and ``fe_sweep=``, with
the extended statistics; its record is :attr:`PipelineBuilder.workload_block`.
With ``serve=true`` its windows are served in the host-extractor mode.

Every fused spelling of the JAX package (``-fused`` and
``-fused-decode|-pallas|-block|-xla``) parses, and all of them run the
one CUDA kernel. ``precision=bf16|int8|int4`` (or ``EEG_TPU_PRECISION``)
runs the kernel's reduced-precision rung on the bare ``-fused`` and
``-fused-decode`` spellings, behind the JAX package's per-run accuracy
gate: the first recording's first 64 rows in both precisions, and f32
for the whole run above the rung's tolerance (recorded in
:attr:`PipelineBuilder.precision_resolved`; the decision is memoized
under the recording's content digest). The fused and seizure paths read
and write the content-addressed feature cache (``io/feature_cache.py``,
on by default; ``cache=false`` or ``EEG_TPU_NO_FEATURE_CACHE=1`` turn it
off): a hit skips parsing the rest, the gate and every kernel launch.
The port has no degradation ladder: ``degrade=`` parses, and a kernel
failure (or an ``ingest.fused`` fault) fails the run.

The input pipeline's knobs: ``ingest_workers=`` sizes every run's
parallel parse pool and ``prefetch=`` its look-ahead (``io/provider.py``;
``EEG_TPU_INGEST_WORKERS``, ``EEG_TPU_PREFETCH_DEPTH``); ``overlap=true``
runs the fused ingest on ``io/staging.prefetch``'s producer thread and
CUDA stream (``EEG_TPU_OVERLAP=1``; recorded in
:attr:`PipelineBuilder.overlap_resolved`), where a ``staging.producer``
fault fails the run. None of them changes a result.

``devices=N`` and ``mesh_axes=data:2,time:4`` (the JAX package's grammar
and messages, ``parallel/mesh.parse_mesh``) build a mesh over the devices
this process sees (``parallel/mesh.make_mesh``: the cards, or N logical
CPU shards for ``device="cpu"``); a mesh the machine cannot build raises,
as there is no ladder. The fused ingest splits each recording over the
mesh's time axis (``parallel/sharded_ingest.py``) and a linear population
its members over the data axis (``models/population.py``); the record is
:attr:`PipelineBuilder.mesh_resolved` (the report's ``mesh`` block).

``processes=N&coordinator=host:port&process_id=i`` (or the env twins
``JAX_NUM_PROCESSES``, ``JAX_COORDINATOR_ADDRESS``/``JAX_COORDINATOR``,
``JAX_PROCESS_ID``; the JAX plan parser's grammar and messages,
``parallel/pod.parse_pod``) make the run one rank of a multi-process pod:
the bootstrap (``parallel/distributed.initialize``: the preflight, then
``torch.distributed``) runs before any mesh, and a live pod's hybrid
mesh (hosts x local devices) supersedes ``devices=``/``mesh_axes=``. The
fused ingest is partitioned by recording (``parallel/pod.py``: each rank
launches K1 on its own block, one all-gather assembles the matrix; no
feature cache) and a linear population's members split over hosts x
devices. ``processes=1`` runs the unchanged path and records the request.
A pod that cannot assemble raises ``distributed.PodBootstrapError`` (the
JAX package degrades to one host; the port has no ladder).

:meth:`PipelineBuilder.execute` parses the query into its
``pipeline/plan.ExecutionPlan`` (every statically decidable conflict
raises there with the JAX package's message, before anything is read) and
runs the plan through the run bracket (``scheduler/runtime.py``):
``faults=``/``faults_seed=`` (or ``EEG_TPU_FAULTS``) install a fault
plan in the run's domain, ``report=`` (or ``EEG_TPU_RUN_REPORT_DIR``)
writes ``run_report.json`` or ``crash_report.json``, and
``trace_path=<dir>`` writes a ``torch.profiler`` trace of the run. Keys
whose paths are not ported yet raise ``ValueError``.

``info_file=``, ``eeg_file=``, ``save_name=`` and ``load_name=`` are
routed by URI scheme (``io/remote.filesystem_for``: ``http(s)://``,
``gs://``, ``hdfs://``, local paths). ``result_path=`` is a local file,
as the JAX package writes it (through ``os``): a ``scheme://``
``result_path`` raises before the run reads anything.
"""

from __future__ import annotations

import contextlib
import logging
import re
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import obs
from ..epochs import extractor
from ..features import registry as fe_registry
from ..io import feature_cache, modelfiles, provider
from ..models import population, registry, seizure, stats
from ..obs import events
from ..ops import decode_ingest
from ..parallel import mesh as pmesh, pod as pod_mod
from ..serve import pipeline as serve_pipeline
from ..utils import java_compat
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

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


def decode_percent_query(query: str) -> str:
    """Percent-decode a network-submitted query string, pair by pair (the
    JAX package's ``decode_percent_query``).

    The gateway's clients URL-encode option values whose grammar carries
    reserved characters (``fe=dwt-8%3Alevel%3D5%3Astats%3Denergy%2Cmean``);
    the journal and the plan IR keep the decoded string. Each parameter is
    split on ``&`` and its first ``=`` before it is unquoted, so a decoded
    ``=`` or ``&`` is never read as query structure; a decoded value
    holding ``&`` (or a decoded name holding ``&`` or ``=``) cannot be
    written in the ``k=v&k=v`` surface and raises ``ValueError``. A string
    without ``%`` passes through unchanged."""
    if "%" not in query:
        return query
    from urllib.parse import unquote

    parts = []
    for param in query.split("&"):
        name, sep, value = param.partition("=")
        name = unquote(name)
        value = unquote(value)
        if "&" in name or "=" in name or "&" in value:
            raise ValueError(
                f"percent-decoded query parameter {param!r} contains a "
                f"reserved '&'/'=' the k=v&k=v surface cannot represent"
            )
        parts.append(name + sep + value)
    return "&".join(parts)


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


def _elastic_kwargs(query_map: Dict[str, str]) -> Optional[dict]:
    """``elastic=true`` -> ``fit_elastic``'s keyword arguments (a manager
    over ``checkpoint_path``, ``save_every`` default 1, ``max_restarts``
    default 3, a divergence sentinel); None when elastic training is
    off."""
    if query_map.get("elastic") != "true":
        return None
    from ..checkpoint.manager import CheckpointManager
    from ..obs import failure

    return {
        "manager": CheckpointManager(query_map["checkpoint_path"]),
        "save_every": int(query_map.get("save_every", 1) or 1),
        "max_restarts": int(query_map.get("max_restarts", 3) or 3),
        "sentinel": failure.DivergenceSentinel(),
    }


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
        #: stage ends in a sync); a pod rank's also bootstrap and exchange
        self.timers: Dict[str, float] = {}
        #: the last run's feature rows on ``device``: the fused run's, or
        #: the host path's one extraction for a population or fan-out;
        #: the last run's targets
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
        #: the last population run's record (the JAX package's
        #: ``telemetry.population``): the block of
        #: ``models.population.run_population``, or ``{"legs": {name:
        #: block}}`` for a fan-out whose SGD legs ran as populations
        self.population_block: Optional[dict] = None
        #: the last population run's members, ``{label: {"state",
        #: "test_index", "predictions"}}`` (for a fan-out, by leg name)
        self.population_states: Optional[dict] = None
        #: the last fan-out's trained plain legs, by name
        self.classifiers: Optional[dict] = None
        #: the last task=seizure run's feature matrices, ``[(fe name, (n,
        #: d) rows on device)]`` (one per ``fe_sweep=`` config)
        self.feature_sets: Optional[list] = None
        #: the last task=seizure run's record (the JAX package's
        #: ``telemetry.workload``): window geometry, window and positive
        #: counts, the resolved class weights and costs, the fe= config(s)
        self.workload_block: Optional[dict] = None
        #: the last fused run's ``{"requested": backend, "landed":
        #: backend or "cache"}`` (the report's ``backend`` block)
        self.backend_resolved: Optional[dict] = None
        #: whether the last fused run's ingest overlapped (``overlap=``,
        #: else ``EEG_TPU_OVERLAP``; the report's ``overlap``); None
        #: before a fused run
        self.overlap_resolved: Optional[bool] = None
        #: the last run's mesh record, ``{"requested", "rung", "shape",
        #: "devices"}`` and the population's ``"population"`` block; on a
        #: pod ``rung: "pod"`` with ``processes``, ``process_id``,
        #: ``coordinator``, ``dcn_shape`` and ``backend``; a ``"pod"`` block
        #: for ``processes=1``; None without ``devices=``/``mesh_axes=`` or
        #: the pod keys
        self.mesh_resolved: Optional[dict] = None
        #: the last run's prefix-dedup record (``scheduler/dedup.py``; the
        #: report's ``dedup`` block): ``{"role", "prefix_key", "rows"}`` and
        #: the leader's ``build_seconds`` or the follower's
        #: ``leader_plan``, ``bytes_saved``, ``seconds_saved``; None when
        #: the run claimed no prefix
        self.dedup_resolved: Optional[dict] = None
        #: the device-pool ordinals the run was granted
        #: (``scheduler/placement.py``, set by the run bracket): a meshed
        #: plan's mesh is built from exactly them; None unplaced
        self.placement_devices: Optional[tuple] = None
        #: the record of a requested pod that did not run one
        #: (``processes=1``), folded into :attr:`mesh_resolved`
        self._pod_block = None
        #: the last run's report telemetry (``obs/report.RunTelemetry``;
        #: None when the run was not reported), per-run metrics scope and
        #: stage timer (the report's ``stages``), set by the run bracket
        self.telemetry = None
        self.run_metrics = None
        self.stage_timer = obs.StageTimer()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _stage(self, name: str, *, into_timers: bool = True, **attrs):
        """A stage: its wall seconds into :attr:`stage_timer` (the
        report's ``stages``) and, unless ``into_timers`` is False, into
        :attr:`timers`, inside a ``stage.<name>`` span carrying
        ``attrs``."""
        t0 = time.perf_counter()
        try:
            with events.span(f"stage.{name}", **attrs):
                yield
        finally:
            elapsed = time.perf_counter() - t0
            self.stage_timer.record(name, elapsed)
            if into_timers:
                self.timers[name] = self.timers.get(name, 0.0) + elapsed

    def _add_timings(self, timings: Dict[str, float]) -> None:
        """A provider's stage seconds, added into :attr:`timers`."""
        for name, seconds in timings.items():
            self.timers[name] = self.timers.get(name, 0.0) + seconds

    def execute(self) -> stats.ClassificationStatistics:
        """Parse the query into its :class:`~.plan.ExecutionPlan` (every
        statically decidable conflict raises there, before anything is
        read) and run it through the run bracket
        (``scheduler/runtime.execute_plan``: fault plan, report, trace)."""
        from ..scheduler import runtime
        from .plan import ExecutionPlan

        return runtime.execute_plan(ExecutionPlan.parse(self.query), self)

    def _execute(self, plan) -> stats.ClassificationStatistics:
        query_map = plan.query_map
        serve = plan.serve
        files = list(plan.input_files)
        self.timers = {}
        self.precision_resolved = self.backend_resolved = self.serve_block = None
        self.overlap_resolved = None
        self.workload_block = self.feature_sets = None
        self.population_block = self.population_states = self.classifiers = None
        self.mesh_resolved = self.dedup_resolved = None
        # the bootstrap runs before any mesh is built; a live pod's hybrid
        # mesh supersedes devices=/mesh_axes=
        pod = self._resolve_pod(plan.pod)
        if pod is not None:
            mesh = pod.mesh
            if plan.mesh is not None:
                logger.info("pod bootstrap succeeded: the hybrid hosts x devices mesh "
                            "supersedes devices=/mesh_axes=")
        else:
            mesh = self._resolve_mesh(plan.mesh)
            self._note_pod_block()

        # task=seizure: sliding windows over interval annotations, subband
        # features on the host, cost-sensitive training, the extended
        # statistics (served with serve=true)
        if plan.task == "seizure":
            if serve:
                statistics, self.serve_block, self.workload_block = (
                    serve_pipeline.run_serve_seizure(
                        query_map,
                        lambda: self._provider(files, plan),
                        self._stage,
                        self.device,
                    )
                )
                return self._finish_run(statistics, query_map)
            pop_spec = plan.population
            fe_names = list(pop_spec.fe_configs) if pop_spec.fe_configs else [plan.fe]
            return self._finish_run(
                self._execute_seizure(plan, files, pop_spec, fe_names, mesh), query_map)

        # serve=true: the saved classifier loads once and every kept
        # epoch becomes a request through the resident micro-batching
        # service; the statistics are the batch load_clf= run's
        if serve:
            statistics, self.serve_block = serve_pipeline.run_serve(
                query_map,
                lambda: self._provider(files, plan),
                self._stage,
                self.device,
            )
            return self._finish_run(statistics, query_map)

        # the plan checked the query's precision=; the environment's
        # EEG_TPU_PRECISION is checked here, as the JAX package's builder does
        precision = resolve_precision(query_map)
        overlap = plan.overlap

        # 2. feature extraction (PipelineBuilder.java:128-139)
        pop_spec = plan.population
        fused = _FUSED_FE.fullmatch(query_map["fe"])
        # an unknown or unported fe= spelling raises here, before loading
        fe = None if fused else fe_registry.create(query_map["fe"], device=self.device)
        odp = self._provider(files, plan)
        if fe is None:
            wavelet_index = int(fused.group(1))
            suffix = fused.group(2)
            backend = "decode" if suffix is None else suffix[1:]
            features, targets = self._fused_features(
                query_map, odp, wavelet_index, backend, precision, overlap, mesh, pod, plan)
            batch = None
        else:
            # the host fe= path (JAX package: pipeline/builder.py:834-840,
            # 904-990): host epochs; classifier.train and classifier.test
            # each featurize their own rows with fe
            batch = odp.load()
            features, targets = None, batch.targets
            self._add_timings(odp.timings)
        self.features, self.targets, self.batch, self.fe = features, targets, batch, fe
        n = len(targets)
        obs.metrics.count("pipeline.epochs_loaded", n)

        if "classifiers" in query_map:
            return self._finish_run(
                self._execute_fanout(query_map, features, targets, batch, fe, pop_spec,
                                     mesh=mesh),
                query_map)
        if "train_clf" in query_map and pop_spec.active:
            return self._finish_run(
                self._execute_population(query_map, features, targets, batch, fe, pop_spec,
                                         mesh),
                query_map)

        # 3. classifier (PipelineBuilder.java:151-284)
        if fe is None:
            return self._finish_run(
                self._fit_and_test(query_map, features, targets, registry.create,
                                   self._config(query_map)),
                query_map)
        if "train_clf" in query_map:
            name = query_map["train_clf"]
            classifier = registry.create(name)
            train_idx, test_idx = java_compat.train_test_split_indices(n, seed=1)
            classifier.set_config(self._config(query_map))
            # elastic=true: chunked training with checkpoints under
            # checkpoint_path, bounded restarts and a divergence sentinel
            elastic = _elastic_kwargs(query_map)
            rows = np.asarray(train_idx, dtype=np.int64)
            if elastic is None:
                classifier.train(batch.epochs[rows], batch.targets[rows], fe)
            else:
                classifier.train_elastic(batch.epochs[rows], batch.targets[rows], fe,
                                         **elastic)
                # the checkpoints guarded this run's training, which is
                # done; left behind, the next run under the directory
                # would restore this trajectory and skip its own
                elastic["manager"].clear()
            logger.info("trained %s", name)
            if query_map.get("save_clf") == "true":
                classifier.save(query_map["save_name"])
        else:
            classifier = registry.create(query_map["load_clf"])
            # load mode tests on ALL shuffled data — no split
            # (PipelineBuilder.java:261-278)
            test_idx = java_compat.java_shuffle_indices(n, seed=1)
            classifier.set_feature_extraction(fe)
            classifier.load(query_map["load_name"])

        rows = np.asarray(test_idx, dtype=np.int64)
        statistics = classifier.test(batch.epochs[rows], batch.targets[rows])
        timings = classifier.timings
        self.timers["featurize"] = timings["featurize"]
        if "fit" in timings:
            self.timers["train"] = timings["fit"]
        self.timers["test"] = timings["predict"]
        self.classifier, self.test_index = classifier, list(test_idx)
        return self._finish_run(statistics, query_map)

    def _provider(self, files, plan) -> provider.OfflineDataProvider:
        """The run's provider on its device: ``ingest_workers=`` sizes the
        parse pool and ``prefetch=`` its look-ahead (the JAX package's
        ``make_provider``; absent, the env defaults)."""
        return provider.OfflineDataProvider(
            files, device=self.device,
            workers=plan.ingest_workers, prefetch_depth=plan.prefetch,
        )

    def _fit_and_test(self, query_map, features, targets, make_classifier, config, **attrs):
        """``train_clf=`` on the seed-1 70/30 split of device feature rows
        (``elastic=true`` through ``fit_elastic``, ``save_clf=true``
        saving), or ``load_clf=`` tested on all rows in the seed-1
        shuffled order; ``make_classifier(name)`` makes the classifier.
        Stages ``train`` and ``test`` carry ``attrs``."""
        n = len(targets)
        if "train_clf" in query_map:
            name = query_map["train_clf"]
            classifier = make_classifier(name)
            classifier.set_config(config)
            train_idx, test_idx = java_compat.train_test_split_indices(n, seed=1)
            # elastic=true: chunked training with checkpoints under
            # checkpoint_path, bounded restarts and a divergence sentinel
            elastic = _elastic_kwargs(query_map)
            x = features.to(classifier.fit_dtype or features.dtype)
            train = torch.as_tensor(train_idx, dtype=torch.long, device=features.device)
            labels = torch.as_tensor(targets[train_idx], dtype=torch.float32,
                                     device=features.device)
            with self._stage("train", classifier=name, elastic=elastic is not None, **attrs):
                if elastic is None:
                    classifier.fit(x[train], labels)
                else:
                    classifier.fit_elastic(x[train], labels, **elastic)
                self._sync()
            if elastic is not None:
                # the checkpoints guarded this run's training, which is
                # done; left behind, the next run under the directory
                # would restore this trajectory and skip its own
                elastic["manager"].clear()
            logger.info("trained %s", name)
            if query_map.get("save_clf") == "true":
                classifier.save(query_map["save_name"])
        else:
            name = query_map["load_clf"]
            classifier = make_classifier(name)
            classifier.load(query_map["load_name"])
            # load mode tests on ALL shuffled data — no split
            # (PipelineBuilder.java:261-278)
            test_idx = java_compat.java_shuffle_indices(n, seed=1)
        rows = np.asarray(test_idx, dtype=np.int64)
        with self._stage("test", classifier=name, **attrs):
            statistics = classifier.test_features(
                features[torch.as_tensor(rows, device=features.device)], targets[rows])
        self.classifier, self.test_index = classifier, list(test_idx)
        return statistics

    def _host_features(self, batch, fe):
        """The host path's whole feature matrix in one extraction pass (a
        row's features depend on its epoch alone, so slicing afterwards
        equals extracting the slices) and the targets."""
        with self._stage("features"):
            # a host extractor's numpy rows (features/subband.py) go to
            # the run's device
            features = torch.as_tensor(fe.extract_batch(np.asarray(batch.epochs, np.float64)),
                                       device=self.device)
            self._sync()
        self.features = features
        return features, np.asarray(batch.targets, dtype=np.float64)

    @staticmethod
    def _config(query_map) -> Dict[str, str]:
        return {k: v for k, v in query_map.items() if k.startswith("config_")}

    def _resolve_mesh(self, request):
        """A validated :class:`~..parallel.mesh.MeshRequest` -> a built
        mesh on the run's device kind, or None when none was requested.
        A placed plan's mesh is built from exactly its leased ordinals
        (:attr:`placement_devices`, recorded as ``mesh_resolved["leased"]``):
        the process's visible CUDA indices on the card, as many logical CPU
        shards on the CPU. A mesh the machine cannot build (more cards than
        visible, a leased ordinal this process cannot see) raises: the port
        has no ladder. Sets :attr:`mesh_resolved`."""
        if request is None:
            return None
        sizes = list(request.shape or ())
        product = int(np.prod(sizes)) if sizes else None
        requested = {"devices": request.devices or product, "axes": list(request.axes),
                     "shape": sizes or None}
        self.mesh_resolved = {"requested": requested, "rung": "single_device", "shape": None}
        leased = self.placement_devices
        shape = tuple(sizes) if sizes else None
        if leased:
            self.mesh_resolved["leased"] = list(leased)
            mesh = pmesh.make_mesh(len(leased), axes=request.axes, shape=shape,
                                   devices=self._leased_devices(leased))
        else:
            mesh = pmesh.make_mesh(requested["devices"], axes=request.axes, shape=shape,
                                   device=self.device)
        self.mesh_resolved.update(rung="mesh", shape=mesh.shape, devices=int(mesh.devices.size))
        events.event("pipeline.mesh_built", devices=int(mesh.devices.size),
                     axes=",".join(mesh.axis_names))
        return mesh

    def _leased_devices(self, leased):
        """The devices of leased pool ordinals: ``cuda:<i>`` for each on the
        card (an ordinal past ``torch.cuda.device_count()`` raises), the
        run's device once each on the CPU."""
        if self.device.type != "cuda":
            return [self.device] * len(leased)
        present = torch.cuda.device_count()
        unseen = [i for i in leased if not 0 <= int(i) < present]
        if unseen:
            raise ValueError(
                f"leased device ordinal(s) {unseen} are not visible to this process "
                f"({present} CUDA device(s) present); replicas that share a device pool "
                "must see the same cards in the same order"
            )
        return [torch.device("cuda", int(i)) for i in leased]

    def _resolve_pod(self, request) -> Optional[pod_mod.PodRuntime]:
        """``processes=``/``coordinator=``/``process_id=`` (or their env
        twins, ``distributed.resolve_env_knobs``) -> a live
        :class:`~..parallel.pod.PodRuntime` over the hybrid mesh, or None
        (no pod asked for, or ``processes=1``: the unchanged path, its
        request recorded by :meth:`_note_pod_block`). A bootstrap that
        cannot assemble raises ``PodBootstrapError`` with the JAX
        package's evidence text (the JAX package degrades to one host
        there); the pod's record is in :attr:`mesh_resolved` first, so a
        crash report carries it."""
        from ..parallel import distributed

        self._pod_block = None
        processes = coordinator = process_id = None
        if request is not None:
            processes, coordinator, process_id = (
                request.processes, request.coordinator, request.process_id)
        coordinator, processes, process_id = distributed.resolve_env_knobs(
            coordinator, processes, process_id)
        if processes is None and coordinator is None:
            if process_id is not None:
                raise ValueError(
                    "JAX_PROCESS_ID/process_id is set but neither a "
                    "coordinator address nor a process count is "
                    "configured — refusing to run as single-process "
                    "with a partial multi-host setup"
                )
            return None
        requested = {"processes": processes, "coordinator": coordinator,
                     "process_id": process_id}
        if processes is not None and processes <= 1:
            # the degenerate pod: the single-process path, only recorded
            self._pod_block = dict(requested, rung="single_host")
            return None
        t0 = time.perf_counter()
        try:
            coordinator_used, n_proc, pid = distributed.initialize(
                coordinator, processes, process_id, device=self.device)
            hmesh = distributed.hybrid_mesh(device=self.device)
            self.timers["bootstrap"] = time.perf_counter() - t0
        except Exception as e:
            evidence = f"{type(e).__name__}: {e}"
            obs.metrics.count("pipeline.pod_unavailable")
            events.event("pipeline.pod_unavailable", error=evidence)
            self.mesh_resolved = {"requested": requested, "rung": "single_device",
                                  "shape": None,
                                  "pod": dict(requested, rung="failed", error=evidence)}
            # a half-assembled bootstrap must not wedge the latch
            distributed.shutdown()
            raise
        self.mesh_resolved = {
            "requested": requested,
            "rung": "pod",
            "shape": hmesh.shape,
            "devices": int(hmesh.devices.size),
            "processes": int(n_proc),
            "process_id": int(pid),
            "coordinator": coordinator_used,
            "dcn_shape": {distributed.DCN_AXIS: int(n_proc)},
            "backend": distributed.backend(),
        }
        events.event("pipeline.pod_up", processes=int(n_proc), process_id=int(pid),
                     devices=int(hmesh.devices.size), backend=distributed.backend())
        obs.metrics.count("pipeline.pod_runs")
        return pod_mod.PodRuntime(mesh=hmesh, num_processes=int(n_proc), process_id=int(pid),
                                  coordinator=coordinator_used)

    def _note_pod_block(self) -> None:
        """A requested pod that runs as one process (``processes=1``):
        its record into the run's mesh block, as ``mesh_resolved["pod"]``."""
        if self._pod_block is None:
            return
        if self.mesh_resolved is None:
            self.mesh_resolved = {
                "requested": {k: self._pod_block.get(k)
                              for k in ("processes", "coordinator", "process_id")},
                "rung": "single_device",
                "shape": None,
            }
        self.mesh_resolved["pod"] = self._pod_block

    def _note_population_mesh(self, block) -> None:
        """The population's mesh record into the run's."""
        mesh_block = (block or {}).get("mesh")
        if mesh_block and self.mesh_resolved is not None:
            self.mesh_resolved["population"] = mesh_block

    def _execute_population(self, query_map, features, targets, batch, fe, pop_spec,
                            mesh=None):
        """``train_clf=<sgd family>`` with population axes: the members
        train through ``models.population.run_population`` (over
        ``mesh``'s member axis for the linear family)."""
        name = query_map["train_clf"]
        if features is None:
            features, targets = self._host_features(batch, fe)
        self.population_states = {}
        statistics, block = population.run_population(
            name, lambda: registry.create(name), self._config(query_map), features, targets,
            pop_spec, stage=self._stage, states=self.population_states, mesh=mesh,
        )
        self._note_population_mesh(block)
        self.population_block = block
        logger.info("trained population %s: %d members (%s)", name, block["members"],
                    block["mode"])
        return statistics

    def _execute_fanout(self, query_map, features, targets, batch, fe, pop_spec,
                        classifier_factory=registry.create, mesh=None):
        """``classifiers=a,b,c``: every named classifier trains and tests
        on the one feature matrix this run made, on the seed-1 70/30
        split, through the calls of a single ``train_clf=`` run (so each
        leg's statistics are that run's). SGD-family legs expand into the
        population when population axes are present; every other leg
        trains once (``population.sequential_legs``). The gathered split
        rows are shared by every leg; legs that train in float32 share
        one float32 buffer of them. ``classifier_factory(name)`` makes each
        leg's classifier (the seizure path's true-confusion-matrix
        variant)."""
        names = [s for s in query_map["classifiers"].split(",") if s]
        if features is None:
            features, targets = self._host_features(batch, fe)
        n = len(targets)
        train_idx, test_idx = java_compat.train_test_split_indices(n, seed=1)
        dev = features.device
        x_train = features[torch.as_tensor(train_idx, dtype=torch.long, device=dev)]
        x_test = features[torch.as_tensor(test_idx, dtype=torch.long, device=dev)]
        y_train = torch.as_tensor(targets[train_idx], dtype=torch.float32, device=dev)
        y_test = targets[test_idx]
        cast = {x_train.dtype: x_train}
        config = self._config(query_map)
        pop_blocks = {}
        statistics = stats.FanOutStatistics()
        self.classifiers, self.population_states = {}, {}
        for name in names:
            with events.span(f"fanout.{name}", classifier=name):
                if pop_spec.active and name in population.SGD_FAMILY:
                    states = self.population_states.setdefault(name, {})
                    statistics[name], pop_blocks[name] = population.run_population(
                        name, lambda name=name: classifier_factory(name), config, features,
                        targets, pop_spec, stage=self._stage, states=states, mesh=mesh,
                    )
                    self._note_population_mesh(pop_blocks[name])
                    obs.metrics.count("pipeline.fanout.classifiers")
                    continue
                if pop_spec.active:
                    logger.warning("population axes do not apply to %s; the leg trains "
                                   "once on the plain split", name)
                    obs.metrics.count("population.sequential_legs")
                classifier = classifier_factory(name)
                classifier.set_config(config)
                dtype = classifier.fit_dtype or x_train.dtype
                x = cast.setdefault(dtype, x_train.to(dtype))
                with self._stage("train", classifier=name):
                    classifier.fit(x, y_train)
                    self._sync()
                logger.info("trained %s", name)
                with self._stage("test", classifier=name):
                    statistics[name] = classifier.test_features(x_test, y_test)
                self.classifiers[name] = classifier
            obs.metrics.count("pipeline.fanout.classifiers")
        if pop_blocks:
            self.population_block = {"legs": pop_blocks}
        self.test_index = list(test_idx)
        return statistics

    # -- the seizure workload ------------------------------------------------

    _seizure_classifier = staticmethod(seizure.seizure_classifier)
    seizure_weights = staticmethod(seizure.seizure_weights)

    def _seizure_features(self, plan, files, slide_cfg, fe_names):
        """One read pass of the session, a feature-cache lookup per
        extractor config (JAX package: pipeline/builder.py:1078-1160;
        the key ``("seizure", fe.cache_id(), window, stride,
        label_overlap)``), then for the misses the session cut into
        sliding windows (stage ``ingest``, its ``parse`` and ``epoch``
        parts in :attr:`timers` too) and each missing extractor over them
        (stage ``features``; a ``-pallas`` extractor on the card launches
        the epoch-features kernel once). Returns ``(feature_sets,
        targets)``: ``(fe name, (n, d) rows on the run's device)`` in
        ``fe_names`` order; a hit's rows go to the device in the dtype a
        miss gives, and launch nothing."""
        query_map = plan.query_map
        odp = self._provider(files, plan)
        # an unknown fe= raises here, before the session is read
        extractors = [(name, fe_registry.create(name, device=self.device)) for name in fe_names]

        def extractor_tuple(fe):
            return ("seizure", fe.cache_id(), slide_cfg.window, slide_cfg.stride,
                    slide_cfg.label_overlap)

        cache = (feature_cache.open_cache()
                 if query_map.get("cache", "true") != "false" else None)
        prepared, keys, hits = None, {}, {}
        if cache is not None:
            with self._stage("ingest", into_timers=False, phase="cache_lookup",
                             task="seizure"):
                prepared = odp.prepare_run(extractor_tuple(extractors[0][1]))
                self._add_timings(odp.timings)
                keys[fe_names[0]] = prepared.key
                for name, fe in extractors[1:]:
                    keys[name] = odp.run_key_for(prepared, extractor_tuple(fe))
                for name, _ in extractors:
                    hit = cache.lookup(keys[name])
                    if hit is not None:
                        hits[name] = hit
        targets = None
        missing = [(name, fe) for name, fe in extractors if name not in hits]
        if missing:
            with self._stage("ingest", task="seizure"):
                if prepared is not None:
                    # the recordings the key pass parsed: no second read
                    t0 = time.perf_counter()
                    batch = extractor.EpochBatch.concatenate([
                        odp.sliding_batch_for(rec, slide_cfg)
                        for _rel, _guessed, rec in prepared.recordings
                    ])
                    self._add_timings({"epoch": time.perf_counter() - t0})
                else:
                    batch = odp.load_sliding(slide_cfg)
                    self._add_timings(odp.timings)
            targets = np.asarray(batch.targets, dtype=np.float64)
            with self._stage("features", task="seizure"):
                for name, fe in missing:
                    rows = torch.as_tensor(fe.extract_batch(batch.epochs), device=self.device)
                    hits[name] = (rows, targets)
                    if cache is not None:
                        cache.store(keys[name], rows.cpu().numpy(), targets)
                self._sync()
            self.batch = batch
        else:
            self.batch = None
        if targets is None:
            targets = np.asarray(hits[fe_names[0]][1], dtype=np.float64)
        feature_sets = [
            (name, torch.as_tensor(hits[name][0], device=self.device)) for name, _ in extractors
        ]
        self.fe = extractors[0][1]
        return feature_sets, targets

    def _seizure_prefix(self, plan, files, slide_cfg, fe_names):
        """:meth:`_seizure_features` behind the plan's prefix-dedup claim
        (``scheduler/dedup.py``; JAX package: pipeline/builder.py:1221-1251):
        a follower takes the leader's published feature sets (on its own
        device) and reads nothing; a leader publishes its own after the
        features stage's sync."""
        from ..scheduler import dedup as dedup_mod

        claim = None
        if dedup_mod.eligible(plan):
            with self._stage("ingest", into_timers=False, phase="prefix_dedup",
                             task="seizure"):
                claim = dedup_mod.acquire_for(plan)
        try:
            if claim is not None and claim.role == "follower":
                shared, targets = claim.value
                feature_sets = [(name, rows.to(self.device)) for name, rows in shared]
                self.batch = None
                self._note_dedup(claim, rows=len(targets))
                logger.info("prefix dedup hit (%d windows, leader %s): seizure ingest and "
                            "featurization skipped", len(targets), claim.leader_plan)
                return feature_sets, targets
            feature_sets, targets = self._seizure_features(plan, files, slide_cfg, fe_names)
            if claim is not None:
                self._sync()
                claim.publish((tuple(feature_sets), targets))
                self._note_dedup(claim, rows=len(targets))
            return feature_sets, targets
        finally:
            if claim is not None:
                # an unpublished leader abandons: the first waiting follower
                # is promoted and computes its own prefix
                claim.settle()

    def _note_dedup(self, claim, rows: int) -> None:
        """The run's prefix-dedup attribution into :attr:`dedup_resolved`
        (the report's ``dedup`` block), with the JAX package's keys."""
        block = {"role": claim.role, "prefix_key": claim.key, "rows": int(rows)}
        if claim.role == "leader":
            block["build_seconds"] = round(claim.build_seconds, 6)
            if claim.leader_failed:
                block["promoted_after_leader_failure"] = True
        else:
            block["leader_plan"] = claim.leader_plan
            block["bytes_saved"] = int(claim.bytes_saved)
            block["seconds_saved"] = round(claim.build_seconds, 6)
        self.dedup_resolved = block

    def _execute_seizure(self, plan, files, pop_spec, fe_names, mesh=None):
        """``task=seizure``: sliding windows -> subband (or any registry)
        features -> cost-sensitive training -> the extended statistics.
        The JAX package's four routes (``classifiers=`` fan-out with the
        resolved class weights, a population, ``train_clf=`` with
        ``elastic=``, ``load_clf=``) over the one feature matrix, the
        classifiers made by :meth:`_seizure_classifier`."""
        query_map = plan.query_map
        slide_cfg = seizure.sliding_config(query_map)
        feature_sets, targets = self._seizure_prefix(plan, files, slide_cfg, fe_names)
        features = feature_sets[0][1]
        n = len(targets)
        if n == 0:
            raise ValueError(
                f"no sliding windows: every recording is shorter than window={slide_cfg.window}"
            )
        obs.metrics.count("pipeline.epochs_loaded", n)
        weights = seizure.seizure_weights(query_map, targets)
        wp, wn, cost_fp, cost_fn = weights
        self.workload_block = seizure.workload_record(
            slide_cfg, targets, weights, fe_names if len(fe_names) > 1 else fe_names[0])
        config = self._config(query_map)
        if wp != 1.0 or wn != 1.0:
            config["config_weight_pos"] = repr(wp)
            config["config_weight_neg"] = repr(wn)
        self.features, self.targets, self.feature_sets = features, targets, feature_sets
        self.population_block = self.population_states = self.classifiers = None

        if "classifiers" in query_map:
            # the fan-out reads its config_* map from the query map: the
            # resolved class weights go in, so every leg trains with them
            fanout_qm = dict(query_map)
            fanout_qm.update({k: v for k, v in config.items()
                              if k.startswith("config_weight_")})
            statistics = self._execute_fanout(fanout_qm, features, targets, None, None,
                                              pop_spec, self._seizure_classifier, mesh)
        elif "train_clf" in query_map and pop_spec.active:
            name = query_map["train_clf"]
            self.population_states = {}
            statistics, self.population_block = population.run_population(
                name, lambda: self._seizure_classifier(name), config, features, targets,
                pop_spec, stage=self._stage, states=self.population_states,
                feature_sets=feature_sets if pop_spec.fe_configs else None, mesh=mesh,
            )
            self._note_population_mesh(self.population_block)
        else:
            statistics = self._fit_and_test(query_map, features, targets,
                                            self._seizure_classifier, config, task="seizure")

        # every seizure report carries the imbalanced-class block
        stats.mark_extended(statistics, cost_fp=cost_fp, cost_fn=cost_fn)
        return statistics

    def _fused_features(self, query_map, odp, wavelet_index: int, backend: str,
                        precision: str, overlap: Optional[bool] = None, mesh=None,
                        pod=None, plan=None):
        """The fused path's feature rows on the run's device, and the
        targets (JAX package: pipeline/builder.py:388-600, without its
        degradation ladder): the prefix-dedup claim (``scheduler/dedup.py``,
        before any I/O: a follower takes the leader's rows, on its own
        device, and reads nothing; a bf16/int8/int4 follower inherits the
        leader's precision decision, its gate record ``{"source": "dedup",
        "leader_plan"}``), the feature-cache lookup, the per-run precision
        gate, the f32 re-key when the gate trips, the kernel run, the
        store, and a leader's publish after the device sync. A cache hit's
        host rows go to the run's device in the dtype a miss gives, and no
        kernel is launched.
        ``overlap`` is the provider's (``None``: ``EEG_TPU_OVERLAP``), as is
        ``mesh`` (the sharded ingest over its time axis). ``pod``: a live
        pod's runtime; its ingest is partitioned by recording and bypasses
        the feature cache (a content key would need every process to
        digest bytes it never reads), and it computes f32 only. Sets
        :attr:`precision_resolved`, :attr:`backend_resolved` and
        :attr:`overlap_resolved`."""
        cache = (feature_cache.open_cache()
                 if query_map.get("cache", "true") != "false" else None)
        if pod is not None:
            if precision != "f32":
                # the grammar refuses precision= on a pod; this is the
                # environment's EEG_TPU_PRECISION
                raise ValueError(
                    f"precision={precision} runs behind a per-run f32 reference "
                    "gate the pod-partitioned ingest cannot stage; pod runs compute f32"
                )
            if cache is not None:
                logger.info("pod run: feature cache bypassed (partitioned ingest "
                            "reads 1/N of the bytes instead)")
                cache = None
        logger.info(
            "fe=%s: fused rung %r runs the CUDA fused-ingest kernel on %s at "
            "precision %s (feature cache %s, no degradation ladder)",
            query_map["fe"], backend, self.device, precision,
            "off" if cache is None else cache.directory,
        )
        prepared = cache_key = build_slot = landed = gate_record = None
        features = targets = None
        precision_used = precision
        from ..scheduler import dedup as dedup_mod

        claim = None
        if pod is None and dedup_mod.eligible(plan):
            with self._stage("ingest", into_timers=False, phase="prefix_dedup"):
                claim = dedup_mod.acquire_for(plan)
        try:
            if claim is not None and claim.role == "follower":
                features, targets = claim.value
                features = features.to(self.device)
                landed = "dedup"
                if precision != "f32":
                    # the leader resolved the gate for this exact prefix
                    precision_used = claim.meta.get("precision_used", precision)
                    gate_record = {"source": "dedup", "leader_plan": claim.leader_plan}
                self._note_dedup(claim, rows=len(targets))
                logger.info("prefix dedup hit (%d rows, leader %s): ingest and featurization "
                            "skipped", len(targets), claim.leader_plan)
            if landed is None and cache is not None:
                with self._stage("ingest", into_timers=False, phase="cache_lookup"):
                    # one read pass: the digests for the key and the parsed
                    # recordings a miss featurizes from memory
                    prepared = odp.prepare_fused_run(
                        provider.fused_extractor_id(wavelet_index, precision))
                    self._add_timings(odp.timings)
                    cache_key = prepared.key
                    # single flight: a concurrent run missing the same
                    # entry waits here for this one's store, then hits
                    build_slot = cache.begin_build(cache_key)
                    hit = cache.lookup(cache_key)
                if hit is not None:
                    features, targets = hit
                    landed = "cache"
                    if precision != "f32":
                        # keys carry the precision class: a non-f32 entry
                        # passed its gate when it was computed
                        gate_record = {"source": "cache"}
                    logger.info("feature cache hit (%d rows): ingest and "
                                "featurization skipped", len(targets))
            if landed is None and precision != "f32":
                if prepared is None:
                    with self._stage("ingest", into_timers=False, phase="cache_lookup"):
                        prepared = odp.prepare_fused_run(
                            provider.fused_extractor_id(wavelet_index, precision))
                        self._add_timings(odp.timings)
                # the per-run accuracy gate (JAX package:
                # pipeline/builder.py:524-570), memoized under the first
                # recording's content digest
                t0 = time.perf_counter()
                with self._stage("ingest", into_timers=False, phase=f"{precision}_gate"):
                    gate_record = odp.precision_gate_check(
                        prepared.recordings, wavelet_index, precision=precision,
                        content_key=prepared.digests[0][2] if prepared.digests else None,
                    )
                self.timers["gate"] = time.perf_counter() - t0
                events.event(f"pipeline.{precision}_gate", **gate_record)
                if not gate_record["ok"]:
                    precision_used = "f32"
                    obs.metrics.count(f"pipeline.{precision}_gate_disabled")
                    logger.warning(
                        "pipeline.%s_gate auto-disable: max abs dev %.3e > gate %.3e; "
                        "the run computes f32",
                        precision, gate_record["max_abs_dev"], gate_record["tolerance"],
                    )
                    # a gated-off run is an f32 run: re-key from the same
                    # read pass, the single-flight slot moved to the new key
                    if cache is not None:
                        cache_key = odp.run_key_for(
                            prepared, provider.fused_extractor_id(wavelet_index, "f32"))
                        build_slot.release()
                        build_slot = cache.begin_build(cache_key)
                        hit = cache.lookup(cache_key)
                        if hit is not None:
                            features, targets = hit
                            landed = "cache"
                            logger.info("feature cache hit (%d rows, f32 fallback): "
                                        "ingest and featurization skipped", len(targets))
            if landed is None:
                with self._stage("ingest", into_timers=False, backend=backend):
                    features, targets = odp.load_features_device(
                        wavelet_index=wavelet_index, backend=backend,
                        precision=precision_used,
                        recordings=None if prepared is None else prepared.recordings,
                        overlap=overlap, mesh=None if pod is not None else mesh, pod=pod,
                    )
                self._add_timings(odp.timings)
                landed = backend
                if cache is not None:
                    cache.store(cache_key, features.cpu().numpy(), targets)
            elif landed == "cache":
                # the entry's host rows, on the run's device as a miss
                # leaves them
                features = torch.from_numpy(np.asarray(features)).to(self.device)
                targets = np.asarray(targets, dtype=np.float64)
            if claim is not None and claim.role == "leader":
                # whatever the run landed on, cache hits included; published
                # after the sync, so no follower reads rows a kernel still writes
                self._sync()
                claim.publish((features, targets), meta={"precision_used": precision_used})
                self._note_dedup(claim, rows=len(targets))
        finally:
            if build_slot is not None:
                build_slot.release()
            if claim is not None:
                # an unpublished leader (any raise) abandons: the first waiting
                # follower is promoted and computes its own prefix
                claim.settle()
        events.event("pipeline.rung_landed", requested=backend, landed=landed)
        self.backend_resolved = {"requested": backend, "landed": landed}
        self.overlap_resolved = provider.default_overlap() if overlap is None else overlap
        self.precision_resolved = (
            {"requested": precision, "used": precision_used, "gate": gate_record}
            if precision != "f32" else None
        )
        return features, targets

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
