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
from eeg_dataanalysispackage_tpu_torch.ops import cuda_build, serve_mega, serve_mega_cuda
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
    with pytest.raises(ValueError, match="not yet ported"):
        solo.swap_model(tenants["bob"])


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
    with pytest.raises(ValueError, match="not yet ported; see ROADMAP.md"):
        MultiplexedEngine(tenants, weights_precision=precision, device="cpu")
    with pytest.raises(ValueError, match="not yet ported; see ROADMAP.md"):
        MultiplexedService(tenants, weights_precision=precision, device="cpu")


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
