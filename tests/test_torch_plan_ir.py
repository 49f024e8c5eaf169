"""The port's ExecutionPlan IR (``pipeline/plan.py``) against the JAX
package's.

Every query of the JAX package's ``tests/test_plan_ir.py`` (its typed
fields, its conflict messages and its pod grammar), and the port's own mesh,
pod, seizure, serve, population and lifecycle queries, parse in both
packages to equal typed fields, ``canonical_key``, ``prefix_key`` and
``device_footprint``, or raise the same error type with the same message.
Parsing reads nothing: the files named need not exist. The port's two own
refusals raise after the JAX checks before them: a ``scheme://``
``result_path`` after every one, a fault point with no injection site where
the JAX parser checks the fault grammar; ``PipelineBuilder.execute`` runs the
parsed plan through ``scheduler/runtime.execute_plan``.
"""

import dataclasses

import pytest

from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan as JaxPlan
from eeg_dataanalysispackage_tpu_torch.obs import chaos
from eeg_dataanalysispackage_tpu_torch.pipeline import plan as plan_mod
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.pipeline.plan import ExecutionPlan, PlanValidationError
from eeg_dataanalysispackage_tpu_torch.scheduler import runtime

BASE = "info_file=i.txt&fe=dwt-8&train_clf=logreg"
FUSED = "info_file=i.txt&fe=dwt-8-fused&train_clf=logreg"
SEIZURE = "info_file=i.txt&task=seizure&fe=dwt-4:level=4:stats=energy&train_clf=logreg"
SERVE = "info_file=i.txt&serve=true&fe=dwt-8-fused&load_clf=logreg&load_name=m"
POD = "&processes=2&coordinator=c:1&process_id=0"

#: tests/test_plan_ir.py's queries, parsed and refused
JAX_SUITE = [
    ("info_file=/data/info.txt&fe=dwt-8-fused-decode&precision=bf16&overlap=true"
     "&train_clf=logreg&cache=false&degrade=false&config_step_size=1.0"
     "&config_num_iterations=40&ingest_workers=3&prefetch=2&result_path=/tmp/r.txt"
     "&faults=remote.request:p=0.2&faults_seed=7&devices=4"),
    ("info_file=i.txt&task=seizure&fe=dwt-4:level=4:stats=energy&window=512&stride=256"
     "&label_overlap=0.4&train_clf=logreg&cost_fp=1&cost_fn=8&class_weight=balanced"
     "&sweep=cost_fn:1,8"),
    "info_file=i.txt&fe=dwt-8&train_clf=logreg&cv=4",
    "fe=dwt-8&train_clf=logreg",
    "info_file=i.txt&task=ecg&fe=dwt-8&train_clf=logreg",
    "info_file=i.txt&fe=dwt-8",
    "info_file=i.txt&train_clf=logreg",
    "info_file=i.txt&fe=dwt-8&load_clf=svm",
    BASE + "&save_clf=true",
    BASE + "&elastic=true",
    "info_file=i.txt&fe=dwt-8&classifiers=logreg&train_clf=svm",
    "info_file=i.txt&fe=dwt-8&classifiers=logreg&elastic=true",
    "info_file=i.txt&fe=dwt-8&classifiers=,",
    "info_file=i.txt&fe=dwt-8&cv=4&load_clf=svm&load_name=m",
    "info_file=i.txt&fe=dwt-8&cv=4&train_clf=dt",
    BASE + "&cv=0",
    BASE + "&precision=bf16",
    "info_file=i.txt&fe=dwt-8-fused-block&train_clf=logreg&precision=bf16",
    FUSED + "&overlap=maybe",
    BASE + "&devices=zero",
    BASE + "&devices=0",
    BASE + "&mesh_axes=data,data",
    BASE + "&devices=4&mesh_axes=data:2,time:4",
    BASE + "&devices=2&serve=true",
    BASE + "&fe_sweep=dwt-4|dwt-8",
    "info_file=i.txt&task=seizure&fe=dwt-8-fused&train_clf=logreg",
    "info_file=i.txt&task=seizure&fe=dwt-4&train_clf=logreg&cost_fn=-1",
    "info_file=i.txt&task=seizure&fe=dwt-4&train_clf=logreg&class_weight=heavy",
    BASE + "&faults=remote.request:maybe",
    "info_file=i.txt&serve=true&fe=dwt-8&load_clf=logreg&load_name=m&cv=4",
    BASE + "&mesh_axes=data:2,time:4",
    "info_file=i.txt&task=seizure&fe=dwt-4&train_clf=logreg&overlap=junk&precision=fp8",
    SERVE + "&overlap=junk&precision=fp8",
    BASE + "&processes=4&coordinator=10.0.0.1:1234&process_id=2",
    BASE + "&processes=2",
    BASE + POD,
    "processes=2&coordinator=c:1&process_id=0&train_clf=logreg&fe=dwt-8&info_file=i.txt",
] + [BASE + "&" + knobs for knobs in (
    "processes=0", "processes=x", "process_id=1", "processes=2&process_id=2",
    "processes=2&process_id=-1", "processes=2&coordinator=nocolon",
    "processes=2&coordinator=h:xyz", "processes=2&coordinator=h:99999",
)] + [
    SERVE + "&processes=2",
    "info_file=i.txt&task=seizure&fe=dwt-4&train_clf=logreg" + POD,
    "info_file=i.txt&fe=dwt-8-fused-decode&train_clf=logreg&precision=bf16" + POD,
]

#: the port's own queries: meshes, pods, the seizure workload, serving and
#: its lifecycle, populations and fan-out, the infrastructure knobs
PORT_SUITE = [
    FUSED, FUSED + "&devices=2", FUSED + "&devices=8&mesh_axes=data:2,time:4",
    FUSED + "&mesh_axes=data", FUSED + "&mesh_axes=time:4", FUSED + "&mesh_axes=data:2,time",
    FUSED + "&mesh_axes=data,time", FUSED + "&mesh_axes=:2", FUSED + "&mesh_axes=data:x",
    FUSED + "&processes=1", FUSED + "&processes=2&coordinator=127.0.0.1:29500&process_id=1",
    FUSED + "&coordinator=127.0.0.1:29500", FUSED + "&cv=2" + POD,
    FUSED + "&devices=2" + POD,
    FUSED + "&precision=int8", FUSED + "&precision=int4&fe=dwt-8-fused-decode",
    FUSED + "&precision=fp8", FUSED + "&precision=f32", FUSED + "&overlap=false",
    "info_file=i.txt&fe=dwt-8-fused-xla&train_clf=logreg&precision=int8",
    "info_file=i.txt&fe=dwt-3-fused-pallas&train_clf=svm",
    "eeg_file=r.eeg&guessed_num=4&fe=dwt-8&train_clf=logreg",
    "eeg_file=r.eeg&fe=dwt-8&train_clf=logreg",
    FUSED + "&ingest_workers=3&prefetch=x", FUSED + "&ingest_workers=0&prefetch=4",
    FUSED + "&faults=serve.batch:once@2;ingest.fused:p=0.5&faults_seed=3",
    FUSED + "&faults=scheduler.journal:p=1.0", FUSED + "&faults=fleet.lease:once@1",
    FUSED + "&faults=fleet.heartbeat:every@2;scheduler.plan:once@1",
    FUSED + "&faults=scheduler.plan:once@0",
    FUSED + "&cache=false&degrade=false&dedup=false&report=/tmp/r&trace_path=/tmp/t"
    "&result_path=/tmp/x.txt",
    FUSED + "&cv=3&seeds=2&sweep=step_size:0.5,1.0", FUSED + "&cv=4&cv_mode=mc",
    FUSED + "&cv=2&cv_mode=loo", FUSED + "&seeds=3&population_mode=looped",
    FUSED + "&seeds=2&population_mode=pmap", FUSED + "&seeds=0",
    FUSED + "&cv=4&seeds=4&sweep=step_size:0.1,1.0",
    FUSED + "&cv=3&save_clf=true&save_name=m", FUSED + "&seeds=2&elastic=true",
    "info_file=i.txt&fe=dwt-8-fused&cv=2&load_clf=logreg&load_name=m",
    FUSED + "&elastic=true&checkpoint_path=/tmp/ck&save_every=2",
    FUSED + "&save_clf=true&save_name=/tmp/m",
    "info_file=i.txt&fe=dwt-8-fused&classifiers=logreg,svm,dt",
    "info_file=i.txt&fe=dwt-8-fused&classifiers=logreg,svm&cv=2",
    "info_file=i.txt&fe=dwt-8-fused&classifiers=logreg&save_clf=true",
    "info_file=i.txt&fe=dwt-8-fused&classifiers=logreg&load_clf=svm",
    "info_file=i.txt&fe=dwt-8-fused&load_clf=logreg&load_name=m",
    "info_file=i.txt&fe=dwt-8-fused&load_clf=logreg",
    "info_file=i.txt&fe=dwt-8-fused&config_step_size=0.5&train_clf=nn&config_layers=2",
    SEIZURE, SEIZURE + "&window=256&stride=128&label_overlap=0.25&class_weight=2.5",
    SEIZURE + "&window=x", SEIZURE + "&stride=1.5", SEIZURE + "&label_overlap=half",
    SEIZURE + "&class_weight=0", SEIZURE + "&cost_fp=0",
    SEIZURE + "&fe_sweep=dwt-4:level=4|dwt-8:level=3",
    SEIZURE + "&fe_sweep=dwt-4:level=4|dwt-4:level=4",
    "info_file=i.txt&task=seizure&fe_sweep=dwt-4:level=4|dwt-8:level=3&classifiers=logreg",
    "info_file=i.txt&task=seizure&fe=dwt-8-pallas&classifiers=logreg,dt&cv=2",
    "info_file=i.txt&task=seizure&train_clf=logreg",
    "info_file=i.txt&task=seizure&fe_sweep=dwt-8-fused|dwt-4&train_clf=logreg",
    SEIZURE + "&cv=2&train_clf=dt", SEIZURE + "&devices=2",
    "info_file=i.txt&task=seizure&serve=true&fe=dwt-4:level=4&load_clf=logreg&load_name=m"
    "&window=256",
    "info_file=i.txt&task=seizure&serve=true&fe=dwt-8-fused&load_clf=logreg&load_name=m",
    "info_file=i.txt&task=seizure&serve=true&fe=dwt-4&load_clf=logreg&load_name=m&cost_fn=0",
    "info_file=i.txt&task=p300&fe=dwt-8&train_clf=logreg", "info_file=i.txt&task=&fe=dwt-8"
    "&train_clf=logreg",
    SERVE, SERVE + "&train_clf=logreg", SERVE + "&devices=2", SERVE + "&mesh_axes=data",
    SERVE + "&adapt=true&swap_gate=cost:2&drift_window=16&adapt_batch=8&adapt_iters=5"
    "&checkpoint_path=/tmp/c",
    SERVE + "&adapt=true&swap_gate=off", SERVE + "&adapt=maybe", SERVE + "&swap_gate=off",
    SERVE + "&adapt=true&swap_gate=bogus", SERVE + "&adapt=true&drift_window=0",
    SERVE + "&drift_window=8", SERVE + "&adapt_batch=8", SERVE + "&adapt=false&adapt_iters=3",
    SERVE + "&adapt=true&drift_window=x", FUSED + "&adapt=true",
    SERVE + "&serve_batch=32&serve_tenant_quota=4&precision=int8",
    "info_file=i.txt&serve=true&fe=dwt-8-fused",
    "info_file=i.txt&serve=false&fe=dwt-8-fused&train_clf=logreg",
]


def _parse(parse, query):
    try:
        return parse(query), None
    except ValueError as e:
        return None, e


def _population(spec):
    if spec is None:
        return None
    return (spec.cv, spec.cv_mode, spec.seeds, spec.sweep, spec.mode, spec.fe_configs,
            spec.active, spec.grid_points())


def _fields(plan):
    out = {}
    for field in dataclasses.fields(plan):
        value = getattr(plan, field.name)
        if field.name == "population":
            value = _population(value)
        elif field.name in ("mesh", "pod"):
            value = None if value is None else dataclasses.astuple(value)
        elif field.name in ("query_map", "config"):
            value = dict(value)
        out[field.name] = value
    return out


@pytest.mark.parametrize("query", JAX_SUITE + PORT_SUITE)
def test_plan_equals_the_jax_package(query):
    ours, our_error = _parse(ExecutionPlan.parse, query)
    theirs, their_error = _parse(JaxPlan.parse, query)
    if their_error is not None:
        assert our_error is not None, f"the port parsed what the JAX package refuses: {query}"
        assert type(our_error).__name__ == type(their_error).__name__
        assert str(our_error) == str(their_error)
        return
    assert our_error is None, f"{type(our_error).__name__}: {our_error}"
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(theirs)]
    assert _fields(ours) == _fields(theirs)
    assert ours.canonical_fields().keys() == theirs.canonical_fields().keys()
    assert ours.canonical_key() == theirs.canonical_key()
    assert ours.prefix_fields() == theirs.prefix_fields()
    assert ours.prefix_key() == theirs.prefix_key()
    assert ours.device_footprint() == theirs.device_footprint()
    assert ours.population_active == theirs.population_active


def test_the_suites_cover_both_outcomes():
    outcomes = [_parse(JaxPlan.parse, q)[1] is None for q in JAX_SUITE + PORT_SUITE]
    assert sum(outcomes) >= 40 and len(outcomes) - sum(outcomes) >= 60
    assert len(set(JAX_SUITE + PORT_SUITE)) == len(JAX_SUITE + PORT_SUITE)


def test_canonical_key_ignores_order_and_non_semantic_knobs():
    a = ExecutionPlan.parse(FUSED + "&cv=2&seeds=2")
    b = ExecutionPlan.parse("seeds=2&train_clf=logreg&cv=2&fe=dwt-8-fused&info_file=i.txt"
                            "&ingest_workers=3&overlap=true&report=/tmp/r")
    assert a.canonical_key() == b.canonical_key() and a.prefix_key() == b.prefix_key()
    c = ExecutionPlan.parse(FUSED + "&cv=3&seeds=2")
    assert c.canonical_key() != a.canonical_key() and c.prefix_key() == a.prefix_key()
    assert ExecutionPlan.parse(SERVE).prefix_key() is None


def test_plans_are_frozen_values():
    a, b = ExecutionPlan.parse(BASE + "&cv=4"), ExecutionPlan.parse(BASE + "&cv=4")
    assert a == b
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.fe = "dwt-4"
    assert issubclass(PlanValidationError, ValueError)


@pytest.mark.parametrize("query,error,match,first", [
    # after every JAX check
    (FUSED + "&result_path=https://127.0.0.1:1/r.txt", PlanValidationError,
     r"result_path='https://127.0.0.1:1/r.txt': remote locations \(https://\)",
     "&train_clf=logreg"),
    # where the JAX parser checks the fault grammar: after the task's
    (FUSED + "&faults=scheduler.dedup:once@1", chaos.FaultSpecError,
     "fault point 'scheduler.dedup' has no injection site", "&task=ecg"),
])
def test_the_ports_own_refusals_follow_every_jax_check(query, error, match, first):
    JaxPlan.parse(query)
    with pytest.raises(error, match=match):
        ExecutionPlan.parse(query)
    broken = query.replace(first, "") if first == "&train_clf=logreg" else query + first
    with pytest.raises(PlanValidationError) as ours:
        ExecutionPlan.parse(broken)
    with pytest.raises(ValueError) as theirs:
        JaxPlan.parse(broken)
    assert str(ours.value) == str(theirs.value)


def test_one_definition_of_each_request_and_grammar():
    from eeg_dataanalysispackage_tpu_torch.parallel import mesh as pmesh
    from eeg_dataanalysispackage_tpu_torch.parallel import pod
    from eeg_dataanalysispackage_tpu_torch.serve import pipeline as serve_pipeline

    assert pmesh.MeshRequest is plan_mod.MeshRequest
    assert pmesh.parse_mesh({"devices": "2"}, serve=False) == plan_mod.MeshRequest(
        2, ("data",), None)
    assert not hasattr(pod, "PodRequest") and not hasattr(pod, "parse_pod")
    assert not hasattr(serve_pipeline, "check_lifecycle_knobs")


def test_builder_execute_runs_the_parsed_plan(monkeypatch):
    seen = {}

    def fake_execute_plan(plan, builder, **kwargs):
        seen.update(plan=plan, builder=builder, kwargs=kwargs)
        return "stats"

    monkeypatch.setattr(runtime, "execute_plan", fake_execute_plan)
    b = PipelineBuilder(FUSED + "&devices=2", device="cpu")
    assert b.execute() == "stats"
    assert isinstance(seen["plan"], ExecutionPlan) and seen["builder"] is b
    assert seen["plan"] == ExecutionPlan.parse(FUSED + "&devices=2")
    assert seen["kwargs"] == {}
    with pytest.raises(PlanValidationError, match="Missing classifier argument"):
        PipelineBuilder("info_file=i.txt&fe=dwt-8", device="cpu").execute()
    assert set(seen) == {"plan", "builder", "kwargs"}
