"""The port's multi-tenant serving against the JAX package, on the CPU.

The same seeded tenants (a JAX-trained logreg model, perturbed per
tenant with numpy) go into the JAX package's ``MultiplexedEngine`` and
the port's: margins agree within ``MEGA_GATE_TOL`` (5e-5), predictions
except rows within 1e-4 of the threshold in both runs, and the host
mirrors exactly. The port's own pins are exact: each tenant's rows of a
mixed batch equal a solo port engine serving that tenant bit for bit,
on the ``mega`` rung (the plain version of the tenant-stacked
megakernel, K6) and on the ``fused`` rung; the plain K6 equals the
plain solo megakernel (K5) run with each lane's weights. Then the admin
path (nothing is built), the batcher's tenant paths (quota shedding
with the JAX package's evidence keys, coalescing across tenants), the
stats block's schema and the tenant spec loaders.

No test depends on timing: a shedding test fills the queue before any
batcher runs, every ``result`` wait has a timeout, and nothing sleeps.
"""

import os
import sys

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.models import registry as jax_registry
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.serve import MultiplexedEngine as JaxMultiplexedEngine
from eeg_dataanalysispackage_tpu.serve import MultiplexedService as JaxMultiplexedService
from eeg_dataanalysispackage_tpu.serve import ServeConfig as JaxServeConfig
from eeg_dataanalysispackage_tpu.serve import pipeline as jax_serve_pipeline
from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
from eeg_dataanalysispackage_tpu_torch.io import deadline as deadline_mod
from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
from eeg_dataanalysispackage_tpu_torch.models import registry
from eeg_dataanalysispackage_tpu.ops import quant as jax_quant
from eeg_dataanalysispackage_tpu_torch.ops import cuda_build, quant, serve_mega, serve_mega_cuda
from eeg_dataanalysispackage_tpu_torch.serve import (
    InferenceService,
    MultiplexedEngine,
    MultiplexedService,
    ServeConfig,
    ServingEngine,
    ShedError,
    batcher as batcher_mod,
    engine,
    multiplex,
    pipeline as serve_pipeline,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

_CONFIG = (
    "&config_num_iterations=20&config_step_size=1.0"
    "&config_mini_batch_fraction=1.0"
)
_NAMES = ("alice", "bob", "carol")
_BAND = 1e-4  # a differing prediction must sit this close to the threshold
_WAIT = 60.0  # every future.result bound


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """Two synthetic files x 90 markers, a logreg model trained and saved
    by the JAX package, and the port's raw windows of the kept epochs."""
    tmp = tmp_path_factory.mktemp("torch_multiplex_session")
    for i, (name, guessed) in enumerate((("synth_00", 2), ("synth_01", 5))):
        _synthetic.write_recording(str(tmp), name=name, n_markers=90,
                                   guessed=guessed, seed=i)
    info = str(tmp / "info.txt")
    with open(info, "w") as f:
        f.write("synth_00.eeg 2\nsynth_01.eeg 5\n")
    model = str(tmp / "model")
    JaxBuilder(
        f"info_file={info}&fe=dwt-8-fused&train_clf=logreg"
        f"&save_clf=true&save_name={model}&cache=false{_CONFIG}"
    ).execute()
    odp = OfflineDataProvider([info], device="cpu")
    balance = BalanceState()
    windows, resolutions = [], None
    for _rel, guessed, rec in odp.iter_recordings():
        ws, _ts, resolutions = engine.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed,
            pre=odp.pre, post=odp.post, balance=balance,
        )
        windows.extend(ws)
    return {"info": info, "model": model, "windows": windows,
            "resolutions": resolutions}


def _jax_tenant(session, seed):
    """The JAX package's test tenant: the trained model, its weights and
    intercept perturbed with numpy per seed (seed 0: unperturbed)."""
    clf = jax_registry.create("logreg")
    clf.load(session["model"])
    if seed:
        r = np.random.default_rng(seed)
        clf.weights = (
            clf.weights + r.standard_normal(clf.weights.shape).astype(np.float32) * 0.05
        ).astype(np.float32)
        clf.intercept = float(r.standard_normal() * 0.01)
    return clf


def _port_of(jax_clf):
    """The same model as a port classifier (models/linear.from_numpy_state)."""
    clf = registry.create("logreg")
    clf.from_numpy_state({
        "weights": np.asarray(jax_clf.weights), "intercept": jax_clf.intercept,
        "margin_threshold": jax_clf.margin_threshold, "config": dict(jax_clf.config),
        "kind": type(jax_clf).__name__,
    })
    return clf


def _tenant(session, seed):
    return _port_of(_jax_tenant(session, seed))


@pytest.fixture(scope="module")
def jax_tenants(session):
    return {name: _jax_tenant(session, seed) for seed, name in enumerate(_NAMES)}


@pytest.fixture(scope="module")
def tenants(jax_tenants):
    return {name: _port_of(clf) for name, clf in jax_tenants.items()}


def _mix(n, names=_NAMES):
    return [names[i % len(names)] for i in range(n)]


def _engine(tenants, **kwargs):
    kwargs.setdefault("capacity", 64)
    eng = MultiplexedEngine(tenants, device="cpu", **kwargs)
    eng.warmup()
    return eng


def _near_threshold_only(pred_a, m_a, pred_b, m_b, thresholds):
    differ = np.nonzero(pred_a != pred_b)[0]
    for r in differ:
        thr = thresholds[r]
        assert abs(m_a[r] - thr) <= _BAND and abs(m_b[r] - thr) <= _BAND, (r, m_a[r], m_b[r])


# -- against the JAX package -----------------------------------------------


@pytest.mark.parametrize("rung", ["auto", "fused"])
def test_margins_match_jax_multiplexed_engine(session, tenants, jax_tenants, rung):
    """A mixed-tenant batch through both packages' engines: margins
    within MEGA_GATE_TOL, predictions equal except near-threshold rows,
    host mirrors equal exactly. ``auto`` is the mega rung in both."""
    windows, res = session["windows"], session["resolutions"]
    mix = _mix(len(windows))
    ours = _engine(tenants, engine_rung=rung)
    theirs = JaxMultiplexedEngine(jax_tenants, capacity=64, engine_rung=rung)
    theirs.warmup()
    assert ours.rung == theirs.rung == ("mega" if rung == "auto" else "fused")
    np.testing.assert_array_equal(ours._w_host, theirs._w_host)
    p_ours, m_ours = ours.execute(windows, res, mix)
    p_theirs, m_theirs = theirs.execute(windows, res, mix)
    dev = float(np.max(np.abs(m_ours - m_theirs)))
    print(f"\n{rung}: max margin deviation from the JAX package {dev:.3e}")
    assert dev <= serve_mega.MEGA_GATE_TOL
    thresholds = [tenants[t].margin_threshold for t in mix]
    _near_threshold_only(p_ours, m_ours, p_theirs, m_theirs, thresholds)


def test_full_128_lane_stack_matches_jax(session):
    """128 tenants: the full stack, a handful of windows spread over
    every lane, against the JAX package's engine on the mega rung."""
    names = [f"t{i:03d}" for i in range(multiplex.MAX_TENANTS)]
    jax_clfs = {name: _jax_tenant(session, 1000 + i) for i, name in enumerate(names)}
    ours = _engine({n: _port_of(c) for n, c in jax_clfs.items()})
    theirs = JaxMultiplexedEngine(jax_clfs, capacity=64)
    theirs.warmup()
    np.testing.assert_array_equal(ours._w_host, theirs._w_host)
    assert ours.tenant_info("t127")["lane"] == 127
    windows = session["windows"][:8]
    for start in range(0, 128, 8):
        mix = names[start:start + 8]
        _, m_ours = ours.execute(windows, session["resolutions"], mix)
        _, m_theirs = theirs.execute(windows, session["resolutions"], mix)
        assert np.max(np.abs(m_ours - m_theirs)) <= serve_mega.MEGA_GATE_TOL
    with pytest.raises(ValueError, match="tenant stack is full"):
        ours.add_tenant("one_more", _port_of(jax_clfs["t000"]))


def test_admin_mirrors_equal_jax_package(session, tenants, jax_tenants):
    """The same add, swap and remove on both engines leave the same host
    mirror, lanes and generations."""
    ours = MultiplexedEngine(tenants, capacity=64, device="cpu")
    theirs = JaxMultiplexedEngine(jax_tenants, capacity=64)
    for eng, make in ((ours, lambda s: _tenant(session, s)),
                      (theirs, lambda s: _jax_tenant(session, s))):
        assert eng.add_tenant("dave", make(77)) == 3
        eng.swap_model(make(78), tenant="bob")
        eng.remove_tenant("alice")
        assert eng.add_tenant("erin", make(79)) == 0
    np.testing.assert_array_equal(ours._w_host, theirs._w_host)
    assert ours.tenants == theirs.tenants
    for name in ours.tenants:
        assert ours.tenant_info(name) == theirs.tenant_info(name)


# -- the port's exact pins -------------------------------------------------


@pytest.mark.parametrize("rung", ["auto", "fused"])
def test_tenant_rows_equal_solo_engine_bit_for_bit(session, tenants, rung):
    """Each tenant's rows of a mixed batch equal a solo port engine
    serving that tenant (margins and predictions), on each rung."""
    windows, res = session["windows"], session["resolutions"]
    mix = _mix(len(windows))
    multi = _engine(tenants, engine_rung=rung)
    mp, mm = multi.execute(windows, res, mix)
    for name, clf in tenants.items():
        solo = ServingEngine(clf, capacity=64, engine_rung=rung, device="cpu")
        solo.warmup()
        assert solo.rung == multi.rung
        sp, sm = solo.execute(windows, res)
        rows = [i for i, t in enumerate(mix) if t == name]
        assert mm[rows].tobytes() == sm[rows].tobytes()
        np.testing.assert_array_equal(mp[rows], sp[rows])


@pytest.mark.parametrize("rung", ["auto", "fused"])
def test_row_margin_independent_of_tenant_mix(session, tenants, rung):
    multi = _engine(tenants, engine_rung=rung)
    windows, res = session["windows"][:12], session["resolutions"]
    mix = _mix(12)
    _, mixed = multi.execute(windows, res, mix)
    for name in _NAMES:
        _, alone = multi.execute(windows, res, [name] * 12)
        rows = [i for i, t in enumerate(mix) if t == name]
        assert mixed[rows].tobytes() == alone[rows].tobytes()


def test_warmup_gate_miss_raises_and_nothing_steps_down(tenants, monkeypatch):
    """The mega gate spreads its windows over the registered tenants; a
    miss raises instead of serving the fused rung."""
    multi = MultiplexedEngine(tenants, capacity=64, device="cpu")
    assert list(multi._gate_lanes(5)) == [0, 1, 2, 0, 1]
    monkeypatch.setenv("EEG_TPU_MEGA_GATE_TOL", "-1")
    with pytest.raises(RuntimeError, match="serve mega warmup gate failed"):
        multi.warmup()
    assert multi.rung == "fused" and multi.mega_record["gate"]["rows_checked"] == 16


def _stack_case(capacity, n, lanes, seed=0):
    """A capacity-``capacity`` serve stream with ``n`` random windows, a
    random 128-lane stack and the host lanes (padded rows lane 0)."""
    rng = np.random.RandomState(seed)
    stride = serve_mega.padded_stride(100, 750)
    windows = [rng.randint(-3000, 3000, size=(3, 850)).astype(np.int16) for _ in range(n)]
    stream = torch.from_numpy(serve_mega.stage_mega_stream(windows, 3, 850, stride, capacity))
    stack = torch.from_numpy(rng.randn(serve_mega.MAX_TENANTS, 48).astype(np.float32))
    full = np.zeros(capacity, np.int32)
    full[:n] = lanes
    res = torch.tensor([0.1, 0.1, 0.2])
    W = torch.from_numpy(serve_mega.dwt.cascade_matrix(8, 512, 16).astype(np.float32))
    return stream, res, W, stack, torch.from_numpy(full), stride


@pytest.mark.parametrize("capacity,n", [(64, 1), (64, 64), (128, 77)])
@pytest.mark.parametrize("spread", ["cycling", "one_lane"])
def test_plain_k6_equals_plain_k5_per_lane(capacity, n, spread):
    lanes = np.arange(n) % 128 if spread == "cycling" else np.full(n, 93)
    stream, res, W, stack, lanes_t, stride = _stack_case(capacity, n, lanes, seed=n)
    before = serve_mega_cuda.MULTI_LAUNCHES
    got = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes_t, 100, 175,
                                                   stride)
    assert serve_mega_cuda.MULTI_LAUNCHES == before  # the CPU runs the plain version
    assert got.numpy().tobytes() == serve_mega.serve_mega_multi_margins_plain(
        stream, res, W, stack, lanes_t, 100, 175, stride).numpy().tobytes()
    present = np.unique(lanes)
    for lane in present[[0, len(present) // 2, -1]]:  # first, middle, last lane
        solo = serve_mega.serve_mega_margins_plain(stream, res, W, stack[int(lane)], 100, 175,
                                                   stride)
        rows = np.nonzero(lanes_t.numpy()[:n] == lane)[0]
        assert got[rows].numpy().tobytes() == solo[rows].numpy().tobytes()
    assert (got[n:] == 0).all()


def test_padded_rows_and_freed_lanes_give_exactly_zero():
    stream, res, W, stack, lanes_t, stride = _stack_case(64, 5, [3, 4, 5, 6, 7])
    stack[5] = 0.0  # a freed lane
    got = serve_mega.serve_mega_multi_margins_plain(stream, res, W, stack, lanes_t, 100, 175,
                                                    stride)
    assert got[2].item() == 0.0
    assert (got[5:] == 0).all() and (got[[0, 1, 3, 4]] != 0).all()


def test_k6_wrapper_checks_stack_and_lanes_on_the_host():
    stream, res, W, stack, lanes, stride = _stack_case(64, 3, [0, 1, 2])
    args = (100, 175, stride)
    call = serve_mega_cuda.serve_mega_multi_margins
    bad = {
        "stack must be": (stack[:64], lanes),
        "stack must be \\(128, 48\\) float32": (stack.double(), lanes),
        "stack must be contiguous": (stack.t().contiguous().t(), lanes),
        "lanes must be a \\(64,\\) int32": (stack, lanes.long()),
        "lanes must lie in \\[0, 128\\)": (stack, torch.where(lanes == 1, 128, lanes)),
        "lanes must lie in": (stack, torch.where(lanes == 1, -1, lanes)),
        "lanes must be on the host": (stack, lanes.to("meta")),
    }
    for match, (s, ln) in bad.items():
        with pytest.raises(ValueError, match=match):
            call(stream, res, W, s, ln, *args)
    program = serve_mega.make_serve_mega_multi_program(capacity=64)
    with pytest.raises(ValueError, match="stack must be \\(128, 48\\)"):
        program(stream, res, stack[:, :47].contiguous(), lanes)


# -- admin ----------------------------------------------------------------


def test_admin_builds_no_kernel_and_no_program(session, tenants):
    """Add, swap and remove publish a new stack and touch nothing else:
    the kernel libraries loaded and built, the megakernel program and
    the fused featurizer are the same objects; the swap lands."""
    multi = _engine(tenants)
    windows, res = session["windows"][:9], session["resolutions"]
    multi.execute(windows, res, _mix(9))
    loaded, logs = dict(cuda_build._LOADED), dict(cuda_build.BUILD_LOGS)
    program, fused, stack = multi._mega_program, multi._fused, multi._stack
    replacement = _tenant(session, 78)
    assert multi.add_tenant("dave", _tenant(session, 77)) == 3
    assert multi.swap_model(replacement, tenant="bob") is tenants["bob"]
    multi.remove_tenant("carol")
    multi.execute(windows, res, ["dave", "bob", "alice"] * 3)
    assert cuda_build._LOADED == loaded and cuda_build.BUILD_LOGS == logs
    assert multi._mega_program is program and multi._fused is fused
    assert multi._stack is not stack and multi.rung == "mega"
    assert multi.tenant_info("bob") == {"lane": 1, "generation": 1}
    solo = ServingEngine(replacement, capacity=64, device="cpu")
    solo.warmup()
    sp, sm = solo.execute(windows, res)
    mp, mm = multi.execute(windows, res, ["bob"] * 9)
    assert mm.tobytes() == sm.tobytes()
    np.testing.assert_array_equal(mp, sp)


def test_remove_tenant_frees_lane_and_refuses_traffic(session, tenants):
    multi = MultiplexedEngine(tenants, capacity=64, device="cpu")
    assert multi.remove_tenant("bob") is tenants["bob"]
    assert "bob" not in multi.tenants
    assert not multi._stack.weights[1].any() and multi._stack.classifiers[1] is None
    with pytest.raises(ValueError, match="unknown tenant 'bob'"):
        multi.execute(session["windows"][:1], session["resolutions"], ["bob"])
    assert multi.add_tenant("erin", _tenant(session, 79)) == 1
    multi.remove_tenant("erin")
    multi.remove_tenant("carol")
    with pytest.raises(ValueError, match="at least one tenant"):
        multi.remove_tenant("alice")


def test_refused_swap_leaves_the_stack_untouched(session, tenants):
    svc = MultiplexedService(
        {"alice": tenants["alice"], "bob": tenants["bob"]},
        config=ServeConfig(max_batch=16), device="cpu",
    )
    svc.engine.warmup()
    windows, res = session["windows"][:8], session["resolutions"]
    stack = svc.engine._stack
    with svc:
        before = {t: [r.margin for r in svc.predict_all(windows, res, t)] for t in ("alice", "bob")}
        f64 = _tenant(session, 5)
        f64.model.weight = f64.model.weight.double()
        with pytest.raises(ValueError, match="not multiplexable"):
            svc.swap_tenant("alice", f64)
        wrong_shape = _tenant(session, 6)
        wrong_shape.model.weight = wrong_shape.model.weight[:7].clone()
        with pytest.raises(ValueError, match="stack shape"):
            svc.swap_tenant("alice", wrong_shape)
        with pytest.raises(ValueError, match="unknown tenant"):
            svc.swap_tenant("zed", _tenant(session, 7))
        after = {t: [r.margin for r in svc.predict_all(windows, res, t)] for t in ("alice", "bob")}
    assert svc.engine._stack is stack
    assert after == before
    assert svc.engine.tenant_info("alice")["generation"] == 0


def test_solo_engine_refuses_tenant_keyed_swap(tenants):
    solo = ServingEngine(tenants["alice"], capacity=64, device="cpu")
    with pytest.raises(ValueError, match="MultiplexedEngine"):
        solo.swap_model(tenants["bob"], tenant="bob")
    assert solo.classifier is tenants["alice"]
    # without tenant= the solo engine's own hot swap (the lifecycle's) runs
    assert solo.swap_model(tenants["bob"]) is tenants["alice"]
    assert solo.classifier is tenants["bob"]


def test_refused_tenants_carry_the_jax_package_message(session, jax_tenants):
    """Non-f32 and untrained (non-linear-family) tenants, an empty
    registry and an unknown weights precision: the JAX package's
    messages."""
    jax_f64 = _jax_tenant(session, 0)
    jax_f64.weights = jax_f64.weights.astype(np.float64)
    ours_f64 = _port_of(jax_f64)
    cases = [
        ({"alice": ours_f64}, {}, {"alice": jax_f64}, {}),
        ({"alice": registry.create("logreg")}, {},
         {"alice": jax_registry.create("logreg")}, {}),
        ({}, {}, {}, {}),
        ({"alice": _port_of(jax_tenants["alice"])}, {"weights_precision": "f16"},
         jax_tenants, {"weights_precision": "f16"}),
    ]
    for ours_t, ours_kw, theirs_t, theirs_kw in cases:
        with pytest.raises(ValueError) as ours:
            MultiplexedEngine(ours_t, capacity=64, device="cpu", **ours_kw)
        with pytest.raises(ValueError) as theirs:
            JaxMultiplexedEngine(theirs_t, capacity=64, **theirs_kw)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantized_weight_stack_is_not_yet_ported(tenants, precision):
    """The quantized stack was refused here until it was ported; it now
    builds, and warmup promotes it: the engine and the service run at
    the requested precision with the packed stack resident (6,656 B at
    int8, 3,584 B at int4), and ``not yet ported`` is raised no more."""
    nbytes = {"int8": 48 * 128 + 128 * 4, "int4": 48 // 2 * 128 + 128 * 4}[precision]
    eng = _engine(tenants, weights_precision=precision)
    assert eng.weights_precision == precision and eng.resident_weight_bytes == nbytes
    svc = MultiplexedService(tenants, weights_precision=precision, device="cpu")
    svc.engine.warmup()
    assert svc.engine.weights_precision == precision
    assert svc.stats_block()["resident_weight_bytes"] == nbytes


def test_no_silent_cpu_without_cuda(tenants):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiplexedService(tenants)


# -- batcher and service ---------------------------------------------------


def test_tenant_quota_sheds_with_the_jax_package_evidence(session, tenants, jax_tenants):
    """Alice's burst sheds against her quota, with the JAX package's
    structured evidence, while bob still admits. No batcher runs: the
    queue only fills, so the boundary is exact."""
    window, res = session["windows"][0], session["resolutions"]
    errors = {}
    for label, svc in (
        ("ours", MultiplexedService(
            {"alice": tenants["alice"], "bob": tenants["bob"]}, device="cpu",
            config=ServeConfig(max_batch=16, queue_depth=64, tenant_quota=2))),
        ("theirs", JaxMultiplexedService(
            {"alice": jax_tenants["alice"], "bob": jax_tenants["bob"]},
            config=JaxServeConfig(max_batch=16, queue_depth=64, tenant_quota=2))),
    ):
        svc._accepting = True
        svc.submit(window, res, tenant="alice")
        svc.submit(window, res, tenant="alice")
        with pytest.raises(ShedError if label == "ours" else Exception) as err:
            svc.submit(window, res, tenant="alice")
        svc.submit(window, res, tenant="bob")
        errors[label] = err.value
        block = svc.stats_block()
        assert block["tenants"]["alice"]["requests"]["shed"] == 1
        assert block["tenants"]["alice"]["requests"]["submitted"] == 3
        assert block["tenants"]["bob"]["requests"]["shed"] == 0
        assert block["requests"]["shed"] == 1
        svc._accepting = False
    ours, theirs = errors["ours"].evidence, errors["theirs"].evidence
    assert set(ours) == set(theirs)
    assert ours["reason"] == "tenant_quota" and ours["tenant"] == "alice"
    assert ours["tenant_depth"] == 2 and ours["tenant_quota"] == 2
    assert ours["queue_depth"] == 2 and ours["depth_limit"] == 64
    assert ours["oldest_age_s"] >= 0.0
    assert {k: v for k, v in ours.items() if k != "oldest_age_s"} == {
        k: v for k, v in theirs.items() if k != "oldest_age_s"}
    assert "alice" in str(errors["ours"])


def test_queue_full_shed_without_a_quota():
    queue = batcher_mod.AdmissionQueue(2, tenant_quota=None)
    w, res = np.zeros((3, 850), np.int16), np.ones(3, np.float32)
    for _ in range(2):
        assert queue.offer(batcher_mod.Request(w, res, deadline_mod.Deadline(5.0), "a"))
    assert not queue.offer(batcher_mod.Request(w, res, deadline_mod.Deadline(5.0), "b"))
    assert queue.last_shed_details["reason"] == "queue_full"
    with pytest.raises(ValueError, match="tenant_quota must be >= 1"):
        batcher_mod.AdmissionQueue(2, tenant_quota=0)


def test_mixed_tenants_share_one_batch_key(session):
    w, res = session["windows"][0], session["resolutions"]
    a = batcher_mod.Request(w, res, deadline_mod.Deadline(5.0), tenant="alice")
    b = batcher_mod.Request(w, res, deadline_mod.Deadline(5.0), tenant="bob")
    assert a.batch_key() == b.batch_key()


def test_mixed_tenant_requests_coalesce_into_shared_batches(session, tenants):
    """Interleaved two-tenant requests queued before the batcher starts
    come out as full mixed batches, each row served by its own tenant."""
    windows, res = session["windows"][:32], session["resolutions"]
    mix = _mix(32, ("alice", "bob"))
    svc = MultiplexedService({"alice": tenants["alice"], "bob": tenants["bob"]},
                             config=ServeConfig(max_batch=16), device="cpu")
    svc.engine.warmup()
    svc._accepting = True
    futures = [svc.submit(w, res, tenant=t) for w, t in zip(windows, mix)]
    with svc:
        results = [f.result(timeout=_WAIT) for f in futures]
    block = svc.stats_block()
    assert [r.batch_size for r in results] == [16] * 32
    assert block["batches"] == 2 and block["mean_batch_size"] == 16.0
    direct_p, direct_m = svc.engine.execute(windows[:16], res, mix[:16])
    assert [r.margin for r in results[:16]] == [float(m) for m in direct_m]
    assert block["tenants"]["alice"]["requests"]["completed"] == 16


def test_tenant_aware_batcher_passes_tenants_and_counts_them():
    seen = []

    def execute(windows, resolutions, tenants):
        seen.append(list(tenants))
        if tenants[0] == "fail":
            raise RuntimeError("boom")
        return np.ones(len(windows)), np.zeros(len(windows), np.float32)

    batcher = batcher_mod.MicroBatcher(execute, max_batch=4, queue_depth=8,
                                       coalesce_s=0.0, max_attempts=2,
                                       retry_backoff_s=0.0, tenant_aware=True)
    w, res = np.zeros((3, 850), np.int16), np.ones(3, np.float32)
    reqs = [batcher_mod.Request(w, res, deadline_mod.Deadline(30.0), t)
            for t in ("a", "b", "a")]
    for r in reqs:
        assert batcher.queue.offer(r)
    batcher.start()
    try:
        for r in reqs:
            r.future.result(timeout=_WAIT)
        failing = batcher_mod.Request(w, res, deadline_mod.Deadline(30.0), "fail")
        assert batcher.queue.offer(failing)
        with pytest.raises(batcher_mod.RequestFailedError):
            failing.future.result(timeout=_WAIT)
    finally:
        batcher.stop()
    assert seen[0] == ["a", "b", "a"]
    counters, _ = batcher.snapshot()
    assert counters["tenant.a.completed"] == 2 and counters["tenant.b.completed"] == 1
    assert counters["tenant.fail.failed"] == 1 and counters["tenant.fail.retries"] == 1
    assert len(batcher.tenant_latency_snapshot()["a"]) == 2
    assert batcher.tenant_histogram_snapshot()["b"].snapshot()
    batcher.evict_tenant("a")
    counters, _ = batcher.snapshot()
    assert not any(k.startswith("tenant.a.") for k in counters)
    assert "a" not in batcher.tenant_latency_snapshot()


def test_service_parity_with_solo_services(session, tenants):
    """The multiplexed service's answers equal each tenant's solo
    service on the same windows (margins bit for bit)."""
    windows, res = session["windows"], session["resolutions"]
    mix = _mix(len(windows))
    svc = MultiplexedService(tenants, config=ServeConfig(max_batch=64), device="cpu")
    with svc:
        served = svc.predict_all(windows, res, mix)
    for name, clf in tenants.items():
        with InferenceService(clf, config=ServeConfig(max_batch=64), device="cpu") as solo:
            alone = solo.predict_all(windows, res)
        rows = [i for i, t in enumerate(mix) if t == name]
        assert [served[i].margin for i in rows] == [alone[i].margin for i in rows]
        assert [served[i].prediction for i in rows] == [alone[i].prediction for i in rows]


def test_service_door_refuses_unknown_or_missing_tenants(session, tenants):
    svc = MultiplexedService(tenants, device="cpu")
    svc._accepting = True
    window, res = session["windows"][0], session["resolutions"]
    with pytest.raises(ValueError, match="unknown tenant 'zed'"):
        svc.submit(window, res, tenant="zed")
    with pytest.raises(ValueError, match="needs tenant="):
        svc.submit(window, res)
    with pytest.raises(ValueError, match="2 tenant ids for 1 windows"):
        svc.predict_all([window], res, ["alice", "bob"])
    assert len(svc.batcher.queue) == 0
    assert svc.stats_block()["requests"]["submitted"] == 0


def test_stats_block_has_the_jax_package_schema(session, tenants, jax_tenants):
    """The tenants sub-block's keys (nested ones included) equal the JAX
    package's; the counts follow the traffic."""
    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            out.add(prefix + k)
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
        return out

    theirs = JaxMultiplexedService(jax_tenants, config=JaxServeConfig(max_batch=16))
    svc = MultiplexedService(tenants, config=ServeConfig(max_batch=16), device="cpu")
    with svc:
        svc.predict_all(session["windows"][:6], session["resolutions"], _mix(6))
        block = svc.stats_block()
    jax_block = theirs.stats_block()
    assert keys(block["tenants"]["alice"]) == keys(jax_block["tenants"]["alice"])
    for key in ("tenants", "tenant_quota", "resident_weight_bytes", "weights_precision"):
        assert key in block and key in jax_block
    assert block["resident_weight_bytes"] == jax_block["resident_weight_bytes"] == 48 * 128 * 4
    assert block["weights_precision"] == "f32" and block["rung"] == "mega"
    assert set(block["tenants"]) == set(_NAMES)
    for name in _NAMES:
        t = block["tenants"][name]
        assert t["requests"]["completed"] == 2 and t["latency_ms"]["n"] == 2
        assert t["latency_ms"]["p99"] >= t["latency_ms"]["p50"] >= 0
        assert t["slo"]["requests_observed"] == 2 and t["slo"]["availability"] == 1.0
        assert t["lifecycle"] is None


def test_queued_requests_of_a_removed_tenant_fail_alone(session, tenants):
    """Bob is removed while his requests sit in the queue with alice's:
    bob's fail with the reason, alice's in the same batches complete
    with her own answers. Everything is queued before the batcher
    starts, so the outcome does not depend on timing."""
    windows, res = session["windows"][:8], session["resolutions"]
    mix = _mix(8, ("alice", "bob"))
    svc = MultiplexedService({"alice": tenants["alice"], "bob": tenants["bob"]},
                             config=ServeConfig(max_batch=16), device="cpu")
    svc.engine.warmup()
    svc._accepting = True
    futures = [svc.submit(w, res, tenant=t) for w, t in zip(windows, mix)]
    svc.remove_tenant("bob")
    with svc:
        outcomes = []
        for f in futures:
            try:
                outcomes.append(f.result(timeout=_WAIT))
            except batcher_mod.RequestFailedError as e:
                outcomes.append(str(e))
    for i, tenant in enumerate(mix):
        if tenant == "bob":
            assert outcomes[i] == "tenant 'bob' was removed before the request ran"
        else:
            assert outcomes[i].attempts == 1 and outcomes[i].batch_size == 4
    _, alice_m = svc.engine.execute(windows[::2], res, ["alice"] * 4)
    assert [outcomes[i].margin for i in range(0, 8, 2)] == [float(m) for m in alice_m]
    block = svc.stats_block()
    assert block["requests"]["failed"] == 4 and block["requests"]["completed"] == 4
    assert block["batch_failures"] == 0


def test_remove_tenant_evicts_its_accounting(session, tenants):
    svc = MultiplexedService(tenants, config=ServeConfig(max_batch=16), device="cpu")
    with svc:
        svc.predict_all(session["windows"][:3], session["resolutions"], "carol")
        svc.remove_tenant("carol")
        with pytest.raises(ValueError, match="unknown tenant"):
            svc.submit(session["windows"][0], session["resolutions"], tenant="carol")
        counters, _ = svc.batcher.snapshot()
    assert not any(k.startswith("tenant.carol.") for k in counters)
    assert counters["tenant_removes"] == 1 and "carol" not in svc.stats_block()["tenants"]


# -- tenant registry loading -------------------------------------------------


@pytest.mark.parametrize("spec", [
    "alice=logreg@/m/a, bob=svm@/m/b", "alice=logreg@/m/a,,", "", "alice",
    "alice=logreg", "alice@/m/a", "=logreg@/m/a", "alice=logreg@/m/a,alice=svm@/m/b",
])
def test_parse_tenant_spec_matches_jax_package(spec):
    try:
        want = jax_serve_pipeline.parse_tenant_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            serve_pipeline.parse_tenant_spec(spec)
        assert str(ours.value) == str(e)
    else:
        got = serve_pipeline.parse_tenant_spec(spec)
        assert got == want and list(got) == list(want)


def test_load_tenants_and_from_saved(session):
    spec = f"alice=logreg@{session['model']},bob=logreg@{session['model']}"
    loaded = serve_pipeline.load_tenants(spec)
    theirs = jax_serve_pipeline.load_tenants(spec)
    assert list(loaded) == list(theirs) == ["alice", "bob"]
    assert loaded["alice"] is not loaded["bob"]
    for name in loaded:
        np.testing.assert_array_equal(loaded[name].model.weight.numpy(), theirs[name].weights)
    with pytest.raises(ValueError) as ours:
        serve_pipeline.load_tenants("alice=tree@/m/a")
    with pytest.raises(ValueError) as want:
        jax_serve_pipeline.load_tenants("alice=tree@/m/a")
    assert str(ours.value) == str(want.value)
    svc = MultiplexedService.from_saved(
        {"alice": ("logreg", session["model"]), "bob": ("logreg", session["model"])},
        config=ServeConfig(max_batch=16), device="cpu",
    )
    assert svc.engine.rung == "mega"
    with svc:
        r = svc.predict_window(session["windows"][0], session["resolutions"], tenant="bob")
    assert r.prediction in (0.0, 1.0)


def test_runtime_tenant_onboarding_from_saved(session, tenants):
    svc = MultiplexedService({"alice": tenants["alice"]}, config=ServeConfig(max_batch=16),
                             device="cpu")
    with svc:
        assert svc.add_tenant_from_saved("frank", "logreg", session["model"]) == 1
        r = svc.predict_window(session["windows"][0], session["resolutions"], tenant="frank")
        assert r.prediction in (0.0, 1.0)
        svc.swap_tenant("frank", _tenant(session, 3))
        assert svc.stats_block()["tenants"]["frank"]["swaps"] == 1
        svc.remove_tenant("frank")
        with pytest.raises(ValueError, match="unknown tenant"):
            svc.submit(session["windows"][0], session["resolutions"], tenant="frank")


@pytest.mark.parametrize("query", [{"serve_tenant_quota": "8"}, {}, {"serve_tenant_quota": "0"}])
def test_serve_tenant_quota_is_read_from_the_query(query):
    want = jax_serve_pipeline.serve_config_from_query(query).tenant_quota
    assert serve_pipeline.serve_config_from_query(query).tenant_quota == want
    assert want == (8 if query.get("serve_tenant_quota") == "8" else None)


# -- the quantized tenant stack (weights_precision=int8|int4) -----------------


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("rung", ["auto", "fused"])
@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantized_engine_matches_jax_quantized_engine(session, tenants, jax_tenants, rung,
                                                       precision):
    """Both packages' engines at the same weights_precision: the stack
    promoted in both, the same resident bytes, weights records with the
    same keys and decision, margins within MEGA_GATE_TOL, predictions
    equal except near-threshold rows. ``auto`` is K6-w8/w4's plain
    version here."""
    windows, res = session["windows"], session["resolutions"]
    mix = _mix(len(windows))
    ours = _engine(tenants, engine_rung=rung, weights_precision=precision)
    theirs = JaxMultiplexedEngine(jax_tenants, capacity=64, engine_rung=rung,
                                  weights_precision=precision)
    theirs.warmup()
    assert ours.rung == theirs.rung
    assert ours.weights_precision == theirs.weights_precision == precision
    assert ours.resident_weight_bytes == theirs.resident_weight_bytes
    assert _keys(ours.weights_record) == _keys(theirs.weights_record)
    assert ours.weights_record["used"] == theirs.weights_record["used"] == precision
    assert ours.weights_record["gate"]["tolerance"] == theirs.weights_record["gate"]["tolerance"]
    if rung == "auto":
        assert ours.mega_record["weights_precision"] == precision
    p_ours, m_ours = ours.execute(windows, res, mix)
    p_theirs, m_theirs = theirs.execute(windows, res, mix)
    dev = float(np.max(np.abs(m_ours - m_theirs)))
    print(f"\n{precision} {rung}: max margin deviation from the JAX package {dev:.3e}")
    assert dev <= serve_mega.MEGA_GATE_TOL
    thresholds = [tenants[t].margin_threshold for t in mix]
    _near_threshold_only(p_ours, m_ours, p_theirs, m_theirs, thresholds)


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantized_stack_gate_promotes_with_margin_parity(session, tenants, precision):
    """The JAX package's promotion scenario: the gate promotes, every
    tenant's margins sit within the weights tolerance of the f32
    engine's, and predictions agree wherever the f32 margin clears it;
    the packed stack is resident, its bytes those of the JAX package's
    quantizer transposed to tenant-major."""
    multi = _engine(tenants, weights_precision=precision)
    rec = multi.weights_record
    assert rec["requested"] == rec["used"] == precision
    gate = rec["gate"]
    assert gate["ok"] and gate["max_abs_dev"] <= gate["tolerance"] and gate["rows_checked"] == 16
    packed, scales = jax_quant.quantize_weight_stack(multi._w_host, precision)
    stack = multi._stack
    assert stack.weights is None and stack.weights_precision == precision
    assert stack.packed.numpy().tobytes() == np.ascontiguousarray(packed.T).tobytes()
    assert stack.scales.numpy().tobytes() == scales.tobytes()
    f32 = _engine(tenants)
    assert f32.resident_weight_bytes == 48 * 128 * 4
    windows, res = session["windows"][:12], session["resolutions"]
    mix = _mix(12)
    qp, qm = multi.execute(windows, res, mix)
    fp, fm = f32.execute(windows, res, mix)
    tol = quant.weights_gate_tolerance(precision, multi._w_host)
    assert float(np.max(np.abs(qm - fm))) <= tol
    clear = np.abs(fm) > tol
    np.testing.assert_array_equal(qp[clear], fp[clear])


@pytest.mark.parametrize("rung", ["auto", "fused"])
@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantized_stack_forced_off_is_identical_to_f32(session, tenants, monkeypatch, rung,
                                                        precision):
    """EEG_TPU_WEIGHTS_GATE_TOL=0 shuts the gate: the f32 stack stands,
    recorded, and the margins equal a plain f32 engine's byte for byte."""
    monkeypatch.setenv("EEG_TPU_WEIGHTS_GATE_TOL", "0")
    multi = _engine(tenants, engine_rung=rung, weights_precision=precision)
    assert multi.weights_precision == "f32"
    rec = multi.weights_record
    assert rec["requested"] == precision and rec["used"] == "f32"
    assert rec["gate"]["ok"] is False and rec["gate"]["tolerance"] == 0.0
    assert multi.resident_weight_bytes == 48 * 128 * 4 and multi._stack.packed is None
    f32 = _engine(tenants, engine_rung=rung)
    windows, res = session["windows"][:12], session["resolutions"]
    mix = _mix(12)
    qp, qm = multi.execute(windows, res, mix)
    fp, fm = f32.execute(windows, res, mix)
    assert qm.tobytes() == fm.tobytes()
    np.testing.assert_array_equal(qp, fp)


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantized_stack_admin_stays_quantized(session, tenants, precision):
    """Add, swap and remove on a promoted stack build nothing, keep it
    quantized, and touch no other lane: every other lane's packed bytes,
    scale and margins stay as they were; the swapped tenant tracks its
    new model within the weights tolerance."""
    multi = _engine(tenants, weights_precision=precision)
    windows, res = session["windows"][:9], session["resolutions"]
    program, loaded = multi._mega_program, dict(cuda_build._LOADED)
    before = multi._stack
    _, alice_before = multi.execute(windows, res, ["alice"] * 9)
    replacement = _tenant(session, 82)
    multi.add_tenant("dave", _tenant(session, 81))
    multi.swap_model(replacement, tenant="bob")
    multi.remove_tenant("dave")
    after = multi._stack
    assert multi.weights_precision == precision and after.weights_precision == precision
    assert multi._mega_program is program and dict(cuda_build._LOADED) == loaded
    others = [lane for lane in range(128) if lane != 1]
    assert after.packed[others].numpy().tobytes() == before.packed[others].numpy().tobytes()
    assert after.scales[others].numpy().tobytes() == before.scales[others].numpy().tobytes()
    _, alice_after = multi.execute(windows, res, ["alice"] * 9)
    assert alice_after.tobytes() == alice_before.tobytes()
    solo = ServingEngine(replacement, capacity=64, device="cpu")
    solo.warmup()
    _, sm = solo.execute(windows, res)
    _, mm = multi.execute(windows, res, ["bob"] * 9)
    assert float(np.max(np.abs(mm - sm))) <= quant.weights_gate_tolerance(precision,
                                                                           multi._w_host)


def test_quantized_batch_holds_its_snapshot_through_a_swap(session, tenants):
    """A batch reads the published quantized stack once: a swap made
    while it runs (here, from inside its margin step) publishes a new
    stack that the batch does not see; the next batch does."""
    multi = _engine(tenants, weights_precision="int8")
    windows, res = session["windows"][:6], session["resolutions"]
    _, want = multi.execute(windows, res, ["bob"] * 6)
    inner = multi._mega_margins

    def swap_then_margins(w, r, model):
        multi.swap_model(_tenant(session, 90), tenant="bob")
        return inner(w, r, model)

    multi._mega_margins = swap_then_margins
    _, got = multi.execute(windows, res, ["bob"] * 6)
    multi._mega_margins = inner
    assert got.tobytes() == want.tobytes()
    _, later = multi.execute(windows, res, ["bob"] * 6)
    assert later.tobytes() != want.tobytes()


def test_failed_quantized_batch_fails_its_requests_and_the_stack_stays(session, tenants):
    """No runtime step-down: a quantized batch whose kernel call fails is
    retried by the batcher and then fails its requests with their
    history; the stack stays quantized and the next batch is served."""
    svc = MultiplexedService(tenants, weights_precision="int4", device="cpu",
                             config=ServeConfig(max_batch=16, max_attempts=2,
                                                retry_backoff_s=0.0))
    svc.engine.warmup()
    program = svc.engine._mega_program

    def failing(*args):
        raise RuntimeError("injected K6-w4 fault")

    windows, res = session["windows"][:3], session["resolutions"]
    with svc:
        svc.engine._mega_program = failing
        futures = [svc.submit(w, res, tenant=t) for w, t in zip(windows, _NAMES)]
        for f in futures:
            with pytest.raises(batcher_mod.RequestFailedError, match="injected K6-w4 fault"):
                f.result(timeout=_WAIT)
        assert svc.engine.weights_precision == "int4" and svc.engine.rung == "mega"
        svc.engine._mega_program = program
        served = svc.predict_all(windows, res, list(_NAMES))
        block = svc.stats_block()
    assert block["requests"]["failed"] == 3 and block["requests"]["completed"] == 3
    assert block["weights_precision"] == "int4" and block["weights"]["used"] == "int4"
    _, want = svc.engine.execute(windows, res, list(_NAMES))
    assert [r.margin for r in served] == [float(m) for m in want]


def test_quantized_stack_raises_on_a_failed_build(tenants, monkeypatch):
    """An exception while the quantized path is built or run at warmup
    raises, and raises again on every later warmup (a service's start
    warms up again): no fallback to the f32 stack is taken quietly. Once
    the fault is gone, warmup promotes the stack."""
    multi = MultiplexedEngine(tenants, capacity=64, weights_precision="int8", device="cpu")

    def broken(*args, **kwargs):
        raise RuntimeError("injected quantizer fault")

    monkeypatch.setattr(quant, "quantize_weight_stack", broken)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected quantizer fault"):
            multi.warmup()
        assert multi.weights_precision == "f32" and multi.weights_record is None
    monkeypatch.undo()
    multi.warmup()
    assert multi.weights_precision == "int8"
    assert multi.weights_record["used"] == "int8"


def test_quantized_stack_raises_on_a_failed_publish(tenants, monkeypatch):
    """A fault in the promoted stack's copy to the device raises on every
    warmup and leaves the f32 stack, its precision and its resident
    bytes as they were."""
    multi = MultiplexedEngine(tenants, capacity=64, weights_precision="int4", device="cpu")
    calls = []
    real = multi._to_device

    def broken(packed_np, scales_np):
        calls.append(len(calls))
        if len(calls) % 2 == 0:  # the gate's copy passes, the publish's fails
            raise RuntimeError("injected copy fault")
        return real(packed_np, scales_np)

    monkeypatch.setattr(multi, "_to_device", broken)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected copy fault"):
            multi.warmup()
        assert multi.weights_precision == "f32" and multi.weights_record is None
        assert multi.resident_weight_bytes == 24_576


def test_quantized_service_stats_match_the_jax_package_schema(session, tenants, jax_tenants):
    """The service's stats block carries the active precision, the full
    weights record and the resident bytes under the JAX package's keys;
    a junk weights_precision is refused with the JAX package's message."""
    svc = MultiplexedService(tenants, config=ServeConfig(max_batch=16),
                             weights_precision="int4", device="cpu")
    svc.engine.warmup()
    theirs = JaxMultiplexedService(jax_tenants, config=JaxServeConfig(max_batch=16),
                                   weights_precision="int4")
    theirs.engine.warmup()
    with svc:
        svc.predict_all(session["windows"][:3], session["resolutions"], list(_NAMES))
        block = svc.stats_block()
    jax_block = theirs.stats_block()
    assert block["weights_precision"] == jax_block["weights_precision"] == "int4"
    assert block["resident_weight_bytes"] == jax_block["resident_weight_bytes"] == 3584
    assert _keys(block["weights"]) == _keys(jax_block["weights"])
    assert block["weights"]["used"] == "int4" and block["weights"]["gate"]["ok"] is True
    assert _keys(block["tenants"]["alice"]) == _keys(jax_block["tenants"]["alice"])
    with pytest.raises(ValueError) as ours:
        MultiplexedEngine(tenants, capacity=64, weights_precision="fp8", device="cpu")
    with pytest.raises(ValueError) as want:
        JaxMultiplexedEngine(jax_tenants, capacity=64, weights_precision="fp8")
    assert str(ours.value) == str(want.value)


def _generic_tenants(n_tenants, K, seed):
    """Random float32 logreg tenants of C*K weights, as port and JAX
    classifiers."""
    rng = np.random.RandomState(seed)
    ours, theirs = {}, {}
    for i in range(n_tenants):
        clf = jax_registry.create("logreg")
        clf.weights = rng.randn(3 * K).astype(np.float32)
        clf.intercept = float(rng.randn() * 0.1)
        theirs[f"g{i}"] = clf
        ours[f"g{i}"] = _port_of(clf)
    return ours, theirs


@pytest.mark.parametrize("precision", ["f32", "int8", "int4"])
@pytest.mark.parametrize("n,K,skip", [(256, 16, 175), (333, 20, 100)])
def test_engines_at_generic_sizes_match_jax(session, precision, n, K, skip):
    """The multiplexed engine at a window and coefficient count off the
    main path (the generic engine's plain version) against the JAX
    package's engine at the same sizes and weights precision: margins
    within MEGA_GATE_TOL on the mega rung."""
    ours_t, theirs_t = _generic_tenants(4, K, seed=n + K)
    kwargs = dict(epoch_size=n, feature_size=K, skip_samples=skip, capacity=64,
                  weights_precision=precision)
    ours = MultiplexedEngine(ours_t, device="cpu", **kwargs)
    ours.warmup()
    theirs = JaxMultiplexedEngine(theirs_t, **kwargs)
    theirs.warmup()
    assert ours.rung == theirs.rung == "mega"
    assert ours.weights_precision == theirs.weights_precision == precision
    windows, res = session["windows"][:20], session["resolutions"]
    mix = [f"g{i % 4}" for i in range(20)]
    _, m_ours = ours.execute(windows, res, mix)
    _, m_theirs = theirs.execute(windows, res, mix)
    assert float(np.max(np.abs(m_ours - m_theirs))) <= serve_mega.MEGA_GATE_TOL
