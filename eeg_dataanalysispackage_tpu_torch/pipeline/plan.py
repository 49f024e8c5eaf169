"""The ExecutionPlan IR: one query string, parsed and validated, no side
effects.

Port of the JAX package's ``pipeline/plan.py``. :meth:`ExecutionPlan.parse`
turns a ``k=v&k=v`` query into a typed, frozen plan (every run-time knob
from ``task=`` to ``processes=`` a field) and raises every statically
decidable conflict as a :class:`PlanValidationError` with the JAX
package's message, in its order. The typed fields,
:meth:`~ExecutionPlan.canonical_key`, :meth:`~ExecutionPlan.prefix_key`
and :meth:`~ExecutionPlan.device_footprint` equal the JAX package's for
the same query. The execution half is ``scheduler/``:
``runtime.execute_plan`` runs one plan in its own fault domain and
``executor.PlanExecutor`` runs N of them; ``PipelineBuilder.execute`` is a
shim over ``parse`` and ``execute_plan``.

Parse reads only the query string: the environment's knobs
(``EEG_TPU_PRECISION``, ``EEG_TPU_FAULTS``, ``EEG_TPU_OVERLAP``, report
directories) are execution-time inputs, so two parses of one query are
equal in any process, and a journaled plan replays by re-parsing its
query. Conditions that need run-time state (a mesh the machine cannot
build, the precision gate, ``class_weight=balanced`` ratios, the serve
conflicts) stay with the builder.

The port refuses two things the JAX parser accepts: a ``scheme://``
``result_path`` after every JAX check (the report is a local file, as the
JAX package writes it), and a ``faults=`` point the port has no injection
site for where the fault grammar is checked (``obs/chaos.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Mapping, Optional, Tuple


class PlanValidationError(ValueError):
    """A query string fails IR validation; a ``ValueError`` carrying the
    JAX package's message."""


def _raise(message: str) -> None:
    raise PlanValidationError(message)


def _int_param(query_map: Mapping[str, str], name: str) -> Optional[int]:
    """An optional integer query parameter (None when absent or empty),
    with the JAX package's message."""
    value = query_map.get(name, "")
    if not value:
        return None
    try:
        return int(value)
    except ValueError:
        _raise(f"query parameter {name}= must be an integer, got {value!r}")


@dataclasses.dataclass(frozen=True)
class MeshRequest:
    """The ``devices=``/``mesh_axes=`` grammar, validated. Whether the
    machine can build the mesh is decided when the run starts."""

    devices: Optional[int]
    axes: Tuple[str, ...]
    shape: Optional[Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class PodRequest:
    """The ``processes=``/``coordinator=``/``process_id=`` grammar,
    validated; fields left None resolve from the env twins
    (``JAX_NUM_PROCESSES``, ``JAX_COORDINATOR``/``_ADDRESS``,
    ``JAX_PROCESS_ID``) when the run starts."""

    processes: Optional[int]
    coordinator: Optional[str]
    process_id: Optional[int]


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """One validated pipeline run. Frozen: the executor journals it,
    retries it and replays it after a crash without re-deciding
    anything."""

    #: the verbatim query string (what the journal records)
    query: str
    #: the parsed k=v map, split at the first '='
    query_map: Mapping[str, str]

    # -- input
    input_files: Tuple[str, ...]
    task: str  # "p300" | "seizure"
    serve: bool

    # -- serving lifecycle
    adapt: bool
    swap_gate: Optional[str]
    drift_window: Optional[int]

    # -- features
    fe: Optional[str]
    fused: bool
    fused_wavelet: Optional[int]
    #: explicit fused suffix ("pallas"|"block"|"xla"|"decode") or None
    fused_backend: Optional[str]
    #: the query's precision= (the env default resolves at execution)
    precision: Optional[str]
    overlap: Optional[bool]
    cache: bool
    degrade: bool
    dedup: bool

    # -- classifier action
    train_clf: Optional[str]
    load_clf: Optional[str]
    classifiers: Tuple[str, ...]
    save_clf: bool
    save_name: Optional[str]
    load_name: Optional[str]
    elastic: bool
    checkpoint_path: Optional[str]
    #: the config_* pass-through surface, verbatim
    config: Mapping[str, str]

    #: ``models.population.PopulationSpec``; None for a serve run, which
    #: never parses the population axes
    population: Optional[object]
    mesh: Optional[MeshRequest]
    pod: Optional[PodRequest]

    # -- seizure workload
    window: Optional[int]
    stride: Optional[int]
    label_overlap: Optional[float]
    class_weight: Optional[str]
    cost_fp: float
    cost_fn: float

    # -- infrastructure
    ingest_workers: Optional[int]
    prefetch: Optional[int]
    faults: Optional[str]
    faults_seed: int
    result_path: Optional[str]
    trace_path: Optional[str]
    report: Optional[str]

    @property
    def population_active(self) -> bool:
        return self.population is not None and self.population.active

    # -- canonicalization: two queries that mean the same run share a key,
    # whatever the order of their parameters; built from the typed fields
    # only, so no environment knob reaches it

    #: fields that never change statistics (pool sizes, overlap, faults
    #: absorbed by contract, artifact locations)
    _NON_SEMANTIC = (
        "query", "query_map", "ingest_workers", "prefetch", "overlap",
        "faults", "faults_seed", "result_path", "trace_path", "report",
    )

    def canonical_fields(self) -> Dict[str, Any]:
        """The plan's semantic fields in hashable canonical form, keyed
        by field name."""
        out: Dict[str, Any] = {}
        for field in dataclasses.fields(self):
            if field.name in self._NON_SEMANTIC:
                continue
            value = getattr(self, field.name)
            if field.name == "population":
                value = None if value is None else (
                    value.cv, value.cv_mode, value.seeds, value.sweep,
                    value.mode, value.fe_configs,
                )
            elif field.name == "mesh":
                value = None if value is None else (value.devices, value.axes, value.shape)
            elif field.name == "pod":
                value = None if value is None else (
                    value.processes, value.coordinator, value.process_id)
            elif field.name == "config":
                value = tuple(sorted(value.items()))
            elif isinstance(value, tuple):
                value = tuple(value)
            out[field.name] = value
        return out

    def canonical_key(self) -> str:
        """Order-insensitive, environment-free digest of the whole plan."""
        return self._digest(b"eeg-tpu-plan-canonical-v1", self.canonical_fields())

    def prefix_fields(self) -> Optional[Dict[str, Any]]:
        """The ingest+featurize half of the plan (the fields that decide
        the feature matrix before any classifier runs), or None for a
        serve run, which never makes the batch matrix. The fused backend
        is included: the prefix identity is byte identity."""
        if self.serve:
            return None
        return {
            "input_files": tuple(self.input_files),
            "task": self.task,
            "fe": self.fe,
            "fe_configs": (
                tuple(self.population.fe_configs)
                if self.population is not None and self.population.fe_configs
                else ()
            ),
            "fused": self.fused,
            "fused_wavelet": self.fused_wavelet,
            "fused_backend": self.fused_backend,
            "precision": self.precision,
            "window": self.window,
            "stride": self.stride,
            "label_overlap": self.label_overlap,
        }

    def prefix_key(self) -> Optional[str]:
        """Digest of :meth:`prefix_fields`, or None without a prefix."""
        fields = self.prefix_fields()
        if fields is None:
            return None
        return self._digest(b"eeg-tpu-plan-prefix-v1", fields)

    @staticmethod
    def _digest(tag: bytes, fields: Mapping[str, Any]) -> str:
        h = hashlib.blake2b(digest_size=20)
        h.update(tag)
        for name in sorted(fields):
            h.update(repr((name, fields[name])).encode())
        return h.hexdigest()

    def device_footprint(self) -> Dict[str, Any]:
        """The plan's static resource footprint, ``{"devices", "hosts",
        "memory_class"}``, from the parsed mesh, pod and population knobs:
        ``devices`` 0 for an axes-only mesh (the whole host), else the
        gang size (1 without a mesh); ``hosts`` ``processes=`` or 1;
        ``memory_class`` ``serve``, ``heavy`` (4+ devices, the whole
        host, a pod or 32+ members), ``standard`` (a smaller population)
        or ``light``. Placement (which consumes it) is not ported."""
        devices = 1
        if self.mesh is not None:
            if self.mesh.shape:
                product = 1
                for extent in self.mesh.shape:
                    product *= int(extent)
                devices = product
            elif self.mesh.devices:
                devices = int(self.mesh.devices)
            else:
                devices = 0
        if devices < 0:
            raise PlanValidationError(
                f"mesh request resolves to a negative device count "
                f"({devices}); the parse grammar should have refused it"
            )
        hosts = 1
        if self.pod is not None and self.pod.processes:
            hosts = max(1, int(self.pod.processes))
        members = 1
        if self.population_active:
            members = (self.population.cv * self.population.seeds
                       * self.population.grid_points()
                       * max(1, len(self.population.fe_configs)))
        if self.serve:
            memory_class = "serve"
        elif devices == 0 or devices >= 4 or hosts > 1 or members >= 32:
            memory_class = "heavy"
        elif members > 1:
            memory_class = "standard"
        else:
            memory_class = "light"
        return {"devices": devices, "hosts": hosts, "memory_class": memory_class}

    @classmethod
    def parse(cls, query: str) -> "ExecutionPlan":
        """Query string -> validated plan; raises
        :class:`PlanValidationError` with the JAX package's messages."""
        from .builder import get_query_map

        query_map: Dict[str, str] = get_query_map(query)

        # 1. input (PipelineBuilder.java:104-113)
        if "info_file" in query_map:
            input_files: Tuple[str, ...] = (query_map["info_file"],)
        elif "eeg_file" in query_map and "guessed_num" in query_map:
            input_files = (query_map["eeg_file"], query_map["guessed_num"])
        else:
            _raise("Missing the input file argument")

        serve = query_map.get("serve") == "true"

        # 1b. the serving lifecycle's knob family: a mistyped gate, or a
        # knob without adapt=true, never serves without the adaptation
        adapt_value = query_map.get("adapt", "")
        if adapt_value not in ("", "true", "false"):
            _raise(f"adapt= must be true or false, got {adapt_value!r}")
        adapt = adapt_value == "true"
        if adapt and not serve:
            _raise(
                "adapt=true streams labeled feedback through the resident "
                "serving service; it requires serve=true"
            )
        swap_gate = query_map.get("swap_gate") or None
        if swap_gate is not None:
            if not adapt:
                _raise("swap_gate= gates lifecycle promotions; it requires adapt=true")
            from ..serve import lifecycle

            try:
                lifecycle.parse_swap_gate(swap_gate)
            except ValueError as e:
                _raise(str(e))
        drift_window = _int_param(query_map, "drift_window")
        if drift_window is not None:
            if not adapt:
                _raise(
                    "drift_window= sizes the lifecycle's windowed statistics; it "
                    "requires adapt=true"
                )
            if drift_window < 1:
                _raise(f"drift_window= must be >= 1, got {drift_window}")
        for knob in ("adapt_batch", "adapt_iters"):
            if _int_param(query_map, knob) is not None and not adapt:
                _raise(
                    f"{knob}= tunes the lifecycle's partial-fit batches; it "
                    "requires adapt=true"
                )

        # 2. the mesh grammar, then the pod's above it
        mesh = cls._parse_mesh(query_map, serve)
        pod = cls._parse_pod(query_map, serve)

        # 3. task
        task = query_map.get("task", "") or "p300"
        if task not in ("p300", "seizure"):
            _raise(
                f"unknown task {query_map.get('task')!r}; supported: "
                f"p300 (default), seizure"
            )
        if task != "seizure" and query_map.get("fe_sweep"):
            _raise(
                "fe_sweep= compares feature configs over the seizure workload; it "
                "requires task=seizure"
            )

        # 4. infrastructure knobs
        ingest_workers = _int_param(query_map, "ingest_workers")
        prefetch = _int_param(query_map, "prefetch")
        faults = query_map.get("faults") or None
        faults_seed = int(query_map.get("faults_seed", 0) or 0)
        if faults:
            # the grammar only: whoever executes parses a fresh plan
            from ..obs import chaos

            chaos.parse_fault_spec(faults, seed=faults_seed)

        # 5. features; the overlap=/precision= value checks belong to the
        # p300 batch route only (the seizure and serve routes ignore them)
        fe = query_map.get("fe") or None
        fused_wavelet: Optional[int] = None
        fused_backend: Optional[str] = None
        fused = False
        precision = query_map.get("precision") or None
        overlap_value = query_map.get("overlap", "")
        overlap = overlap_value == "true" if overlap_value in ("true", "false") else None
        if task == "p300" and not serve:
            if overlap_value not in ("", "true", "false"):
                _raise(f"overlap= must be true or false, got {overlap_value!r}")
            if precision is not None and precision not in ("f32", "bf16", "int8", "int4"):
                _raise(f"precision= must be f32, bf16, int8, or int4, got {precision!r}")
            import re

            fused_match = re.fullmatch(r"dwt-(\d+)-fused(-pallas|-block|-xla|-decode)?",
                                       query_map.get("fe", ""))
            fused = fused_match is not None
            if fused:
                fused_wavelet = int(fused_match.group(1))
                suffix = fused_match.group(2)
                if suffix is not None:
                    fused_backend = suffix[1:]
            if precision in ("bf16", "int8", "int4"):
                if not fused:
                    _raise(
                        f"precision={precision} applies to the fused fe= modes "
                        "(fe=dwt-<i>-fused[-decode]); host-path features are "
                        "the bit-parity reference and stay f64"
                    )
                if fused_backend is not None and fused_backend != "decode":
                    _raise(
                        f"precision={precision} rides the decode rung; it cannot "
                        f"combine with the explicit fe=...-fused-{fused_backend} backend"
                    )
            if fe is None:
                _raise("Missing the feature extraction argument")

        # 6. population axes (a serve run parses none)
        population = None
        if not serve:
            from ..models import population as population_mod

            population = population_mod.PopulationSpec.from_query_map(query_map)

        # 7. classifier action and its conflicts
        train_clf = query_map.get("train_clf") if "train_clf" in query_map else None
        load_clf = query_map.get("load_clf") if "load_clf" in query_map else None
        classifiers: Tuple[str, ...] = ()
        save_clf = query_map.get("save_clf") == "true"
        elastic = query_map.get("elastic") == "true"
        checkpoint_path = query_map.get("checkpoint_path") or None
        if not serve:
            cls._validate_action(query_map, task, population, train_clf, load_clf,
                                 save_clf, elastic, checkpoint_path)
            if "classifiers" in query_map:
                classifiers = tuple(s for s in query_map["classifiers"].split(",") if s)

        # 8. the seizure workload's typed knobs (the balanced ratio needs
        # the targets and is checked when the run has them)
        window = stride = None
        label_overlap = None
        class_weight = None
        cost_fp = cost_fn = 1.0
        if task == "seizure":
            window = _int_param(query_map, "window")
            stride = _int_param(query_map, "stride")
            label_overlap = float(query_map.get("label_overlap") or 0.5)
            cost_fp = float(query_map.get("cost_fp") or 1.0)
            cost_fn = float(query_map.get("cost_fn") or 1.0)
            if cost_fp <= 0 or cost_fn <= 0:
                _raise(f"cost_fp=/cost_fn= must be > 0, got {cost_fp}/{cost_fn}")
            cw = query_map.get("class_weight", "")
            if cw and cw != "balanced":
                try:
                    wp = float(cw)
                except ValueError:
                    _raise(f"class_weight= must be 'balanced' or a float, got {cw!r}")
                if wp <= 0:
                    _raise(f"class_weight= must be > 0, got {wp}")
            class_weight = cw or None
            if not serve:
                fe_names = (list(population.fe_configs)
                            if population is not None and population.fe_configs
                            else ([fe] if fe else []))
                if not fe_names:
                    _raise("Missing the feature extraction argument")
                for name in fe_names:
                    if "-fused" in name:
                        _raise(
                            "task=seizure extracts features on the host; fe= must be a "
                            "registry form (e.g. dwt-4:level=4:stats=energy), not a "
                            "-fused mode"
                        )

        # 9. the port's own refusal, after every JAX check
        from ..io import remote

        scheme = remote.uri_scheme(query_map.get("result_path", ""))
        if scheme is not None:
            _raise(
                f"result_path={query_map['result_path']!r}: remote locations ({scheme}://) "
                "are not supported; the report is a local file, as the JAX package "
                "writes it (see ROADMAP.md)"
            )

        return cls(
            query=query,
            query_map=query_map,
            input_files=input_files,
            task=task,
            serve=serve,
            adapt=adapt,
            swap_gate=swap_gate,
            drift_window=drift_window,
            fe=fe,
            fused=fused,
            fused_wavelet=fused_wavelet,
            fused_backend=fused_backend,
            precision=precision,
            overlap=overlap,
            cache=query_map.get("cache", "true") != "false",
            degrade=query_map.get("degrade", "true") != "false",
            dedup=query_map.get("dedup", "true") != "false",
            train_clf=train_clf,
            load_clf=load_clf,
            classifiers=classifiers,
            save_clf=save_clf,
            save_name=query_map.get("save_name") or None,
            load_name=query_map.get("load_name") or None,
            elastic=elastic,
            checkpoint_path=checkpoint_path,
            config={k: v for k, v in query_map.items() if k.startswith("config_")},
            population=population,
            mesh=mesh,
            pod=pod,
            window=window,
            stride=stride,
            label_overlap=label_overlap,
            class_weight=class_weight,
            cost_fp=cost_fp,
            cost_fn=cost_fn,
            ingest_workers=ingest_workers,
            prefetch=prefetch,
            faults=faults,
            faults_seed=faults_seed,
            result_path=query_map.get("result_path") or None,
            trace_path=query_map.get("trace_path") or None,
            report=query_map.get("report") or None,
        )

    # -- validation helpers

    @staticmethod
    def _parse_mesh(query_map: Mapping[str, str], serve: bool) -> Optional[MeshRequest]:
        """The ``devices=``/``mesh_axes=`` grammar; the typed request, or
        None when neither key is given."""
        devices_param = _int_param(query_map, "devices")
        axes_value = query_map.get("mesh_axes", "")
        if devices_param is None and not axes_value:
            return None
        if serve:
            _raise(
                "devices=/mesh_axes= shard the batch pipeline; they "
                "cannot combine with serve=true (the serving engine "
                "is resident single-device)"
            )
        axes = []
        sizes = []
        if axes_value:
            for part in axes_value.split(","):
                name, sep, size = part.partition(":")
                name = name.strip()
                if not name:
                    _raise(f"mesh_axes= has an empty axis name in {axes_value!r}")
                axes.append(name)
                if sep:
                    try:
                        sizes.append(int(size))
                    except ValueError:
                        _raise(f"mesh_axes= axis {name!r} has a non-integer extent {size!r}")
            if len(set(axes)) != len(axes):
                _raise("mesh_axes= repeats an axis name")
            if sizes and len(sizes) != len(axes):
                _raise(
                    "mesh_axes= extents must be given for every axis "
                    "or for none (e.g. mesh_axes=data:2,time:4)"
                )
            if len(axes) > 1 and not sizes:
                _raise(
                    "multi-axis mesh_axes= needs explicit extents "
                    "(e.g. mesh_axes=data:2,time:4)"
                )
        if not axes:
            from ..parallel import mesh as pmesh

            axes = [pmesh.DATA_AXIS]
        if devices_param is not None and devices_param < 1:
            _raise("devices= must be >= 1")
        product = None
        if sizes:
            product = 1
            for extent in sizes:
                product *= extent
        if product is not None and devices_param is not None and product != devices_param:
            _raise(
                f"mesh_axes= extents cover {product} devices but "
                f"devices={devices_param}; drop one or make them agree"
            )
        return MeshRequest(devices=devices_param, axes=tuple(axes),
                           shape=tuple(sizes) if sizes else None)

    @staticmethod
    def _parse_pod(query_map: Mapping[str, str], serve: bool) -> Optional[PodRequest]:
        """The ``processes=``/``coordinator=``/``process_id=`` grammar:
        statically decidable errors only; None when none is given."""
        processes = _int_param(query_map, "processes")
        process_id = _int_param(query_map, "process_id")
        coordinator = query_map.get("coordinator") or None
        if processes is None and process_id is None and coordinator is None:
            return None
        if serve:
            _raise(
                "processes=/coordinator=/process_id= configure the "
                "multi-process batch pipeline; they cannot combine "
                "with serve=true (the serving engine is resident "
                "single-process)"
            )
        if (query_map.get("task", "") or "p300") == "seizure":
            _raise(
                "processes=/coordinator=/process_id= partition the "
                "fused P300 ingest; task=seizure has no pod path yet "
                "— run it single-host (devices= still shards the "
                "member axis)"
            )
        if query_map.get("precision") in ("bf16", "int8", "int4"):
            _raise(
                f"precision={query_map.get('precision')} runs behind "
                "a per-run f32 reference gate the pod-partitioned "
                "ingest cannot stage; pod runs compute f32"
            )
        if processes is not None and processes < 1:
            _raise("processes= must be >= 1")
        if coordinator is not None:
            host, sep, port = coordinator.rpartition(":")
            if not sep or not host:
                _raise(f"coordinator= must be host:port, got {coordinator!r}")
            try:
                port_n = int(port)
            except ValueError:
                _raise(f"coordinator= port must be an integer, got {port!r}")
            if not 0 < port_n < 65536:
                _raise(f"coordinator= port must be in (0, 65536), got {port_n}")
        if process_id is not None:
            if process_id < 0:
                _raise("process_id= must be >= 0")
            if processes is None:
                _raise("process_id= identifies this process within processes=N; pass both")
            if process_id >= processes:
                _raise(f"process_id= must be < processes={processes}, got {process_id}")
        return PodRequest(processes=processes, coordinator=coordinator, process_id=process_id)

    @staticmethod
    def _validate_action(query_map, task, population, train_clf, load_clf, save_clf,
                         elastic, checkpoint_path) -> None:
        """The classifier-action conflict rules; a ``task=seizure`` run
        names ``fe_sweep=`` among the population axes."""
        from ..models import population as population_mod

        pop_active = population is not None and population.active
        axes_label = "cv=/seeds=/sweep=/fe_sweep=" if task == "seizure" else "cv=/seeds=/sweep="
        if pop_active:
            if load_clf is not None:
                _raise(
                    f"population axes ({axes_label}) train models; they cannot "
                    f"combine with load_clf="
                )
            if save_clf:
                _raise(
                    "population runs train many members; save_clf= has no single "
                    "model to persist"
                )
            if elastic:
                _raise(
                    "population training does not support elastic=true; the stacked "
                    "program has no per-member checkpoints"
                )
        if population is not None and population.fe_configs and "classifiers" in query_map:
            _raise(
                "fe_sweep= expands the train_clf= population; it cannot combine with "
                "classifiers="
            )
        if "classifiers" in query_map:
            if train_clf is not None or load_clf is not None:
                _raise("classifiers= replaces train_clf=/load_clf=; pass exactly one of them")
            if save_clf:
                _raise(
                    "classifiers= fan-out does not support save_clf; train the model to "
                    "persist via train_clf="
                )
            if elastic:
                _raise(
                    "classifiers= fan-out does not support elastic=true; use train_clf= "
                    "for elastic training"
                )
            if not [s for s in query_map["classifiers"].split(",") if s]:
                _raise("classifiers= requires a comma-separated classifier list")
            return
        if train_clf is not None:
            if pop_active and train_clf not in population_mod.SGD_FAMILY:
                sgd = ", ".join(population_mod.SGD_FAMILY)
                _raise(
                    f"population axes ({axes_label}) apply to the SGD family "
                    f"({sgd}); {train_clf!r} trains one model per run"
                )
            if elastic and not pop_active and not checkpoint_path:
                _raise("elastic=true requires a checkpoint_path query parameter")
            if save_clf and "save_name" not in query_map:
                _raise(
                    "Please provide a location to save a classifier within the save_name "
                    "query parameter"
                )
            return
        if load_clf is not None:
            if "load_name" not in query_map:
                _raise("Classifier location not provided")
            return
        _raise("Missing classifier argument")
