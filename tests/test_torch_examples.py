"""The port's walkthroughs (``eeg_dataanalysispackage_tpu_torch/examples``)
against the JAX package's library calls that its ``examples/`` scripts
make, on the same numpy-seeded inputs, on the CPU at small sizes (the
JAX scripts' ``main()`` is not run: its sizes cost minutes here, and
``sharded_long_recording``'s rewrites ``XLA_FLAGS`` in-process).

Tolerances, each an existing parity test's for the same functions:

- ``train_p300``: both statistics byte-equal to the JAX run's
  (``tests/test_torch_pipeline.py`` pins byte identity);
- ``fused_ingest``: the plain rows against the JAX package's ``exact``
  Pallas kernel in interpret mode within 1e-6, and the regular-train rows
  against its regular featurizer within 5e-5
  (``tests/test_torch_ingest.py``, ``tests/test_torch_parallel_train.py``);
  K1's wrapper on CPU tensors is the plain version, bit for bit;
- ``raw_stream_training``: from the JAX package's own initial weights,
  carried over (``parallel/train.as_params``), the regular step's losses
  within 1e-5 and the irregular step's within 1e-6 relative
  (``tests/test_torch_parallel_train.py``); the crash leaves the JAX
  run's checkpoints, and the resumed parameters equal the uninterrupted
  run's bit for bit;
- ``sharded_long_recording``: the sharded rows within 5e-5 of the JAX
  package's (``tests/test_torch_sharded_ingest.py``) and bit-equal to the
  port's unsharded rows, the plan's targets equal, the logreg weights
  within 2e-5 of the JAX SGD on the same rows and the raw-stream losses
  within 1e-5 (``tests/test_torch_parallel_train.py``);
- ``stream_continuous``: the blocked and the mesh rows within 2e-5 of
  the JAX package's and of each other before the ring wraps
  (``tests/test_torch_streaming.py``);
- ``mllib_migration``: every prediction equal to the JAX classes' on the
  same directories (``tests/test_torch_mllib_format.py``,
  ``tests/test_torch_trees.py``).

Then each walkthrough's ``main`` with ``--device cpu`` at small sizes
(its printed lines), and without ``--device`` on a host without a card
(``resolve_device``'s error).
"""

import contextlib
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from eeg_dataanalysispackage_tpu.checkpoint import run_resumable as jax_run_resumable
from eeg_dataanalysispackage_tpu.io.provider import OfflineDataProvider as JaxProvider
from eeg_dataanalysispackage_tpu.models import registry as jax_registry
from eeg_dataanalysispackage_tpu.models import sgd as jax_sgd
from eeg_dataanalysispackage_tpu.ops import device_ingest as jax_device_ingest
from eeg_dataanalysispackage_tpu.ops import ingest_pallas
from eeg_dataanalysispackage_tpu.parallel import train as jax_train
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch.examples import (
    fused_ingest,
    mllib_migration,
    raw_stream_training,
    sharded_long_recording,
    stream_continuous,
    train_p300,
)
from eeg_dataanalysispackage_tpu_torch.ops import device_ingest, ingest_cuda

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

PLAIN_TOL = 1e-6  # plain rows vs the JAX exact kernel
REGULAR_TOL = 5e-5  # the regular featurizer's rows vs the JAX package's
BLOCK_TOL = 5e-5  # sharded rows vs the JAX package's block/sharded rows
F32_TOL = 2e-5  # float32 contractions: streaming rows, SGD weights
RAW_LOSS_TOL = 1e-5  # the regular raw step's losses
IRREGULAR_REL_TOL = 1e-6  # the irregular step's losses, relative


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("p300")))


def _jax_params(seed):
    return {k: np.asarray(v) for k, v in
            jax_train.init_mlp_params(jax.random.PRNGKey(seed)).items()}


# -- each walkthrough against the JAX package's library calls -------------------------------


def test_train_p300_statistics_equal_the_jax_run(session):
    out = train_p300.run(session, device="cpu")
    query = (f"info_file={session}&fe=dwt-8-tpu&train_clf=logreg&config_num_iterations=100"
             "&config_step_size=1.0&config_mini_batch_fraction=1.0")
    assert str(out["query_statistics"]) == str(JaxBuilder(query).execute())
    features, targets = JaxProvider([session]).load_features_device()
    clf = jax_registry.create("logreg")
    clf.fit(features, targets)
    assert str(out["fused_statistics"]) == str(clf.test_features(features, targets))
    assert out["features_shape"] == tuple(np.shape(features))
    assert out["k1_launches"] == 0  # the CPU runs K1's plain version


def test_fused_ingest_rows_match_the_jax_formulations():
    n, stride = 24, 800
    out = fused_ingest.run(device="cpu", n=n, stride=stride)
    raw, res = out["raw"], out["resolutions"]
    plain = out["plain"].numpy()
    assert plain.shape == (n, 48)
    want = np.asarray(ingest_pallas.ingest_features_pallas(
        raw, res, out["positions"], chunk=8192, tile_b=8, interpret=True, mode="exact"))
    np.testing.assert_allclose(plain, want, rtol=0, atol=PLAIN_TOL)
    assert torch.equal(out["k1"], out["plain"]) and out["max_abs_diff"] == 0.0
    jax_reg = np.asarray(jax_device_ingest.make_regular_ingest_featurizer(stride, n)(
        jnp.asarray(raw), jnp.asarray(res), 200))
    np.testing.assert_allclose(out["regular"].numpy(), jax_reg, rtol=0, atol=REGULAR_TOL)
    # the regular featurizer is K1 at first + k * stride
    assert torch.equal(out["regular"], ingest_cuda.ingest_features_cuda(
        torch.from_numpy(raw), torch.from_numpy(res), out["regular_positions"]))
    assert out["k1_launches"] == 0


def test_raw_stream_training_matches_the_jax_steps_and_resumes_bit_identically(tmp_path):
    n, cap, stride, first = 32, 64, 800, 150
    out = raw_stream_training.run(device="cpu", n=n, cap=cap,
                                  keys=tuple(_jax_params(s) for s in (0, 1, 2)))
    # the JAX package's steps on the same seeded stream, from the same weights
    rng = np.random.RandomState(0)
    S = 200 + n * stride + 8192
    raw = jnp.asarray(rng.randint(-3000, 3000, size=(3, S), dtype=np.int16))
    res = jnp.asarray(raw_stream_training.RESOLUTIONS)
    labels = (rng.rand(n) > 0.5).astype(np.float32)
    init_state, step = jax_train.make_raw_train_step(stride, n, donate_state=False)
    state = init_state(jax.random.PRNGKey(0))
    for loss in out["regular_losses"]:
        state, jloss = step(state, raw, res, jnp.asarray(labels), jnp.ones((n,), jnp.float32),
                            first)
        assert abs(float(jloss) - loss) <= RAW_LOSS_TOL
    positions = np.sort(rng.choice(np.arange(200, S - 900), size=cap, replace=False)
                        ).astype(np.int32)
    mask = np.ones(cap, bool)
    labels_irr = (rng.rand(cap) > 0.5).astype(np.float32)
    init_irr, irr_step = jax_train.make_irregular_train_step(donate_state=False)
    state_irr = init_irr(jax.random.PRNGKey(1))
    for loss in out["irregular_losses"]:
        state_irr, jloss = irr_step(state_irr, raw, res, jnp.asarray(positions),
                                    jnp.asarray(mask), jnp.asarray(labels_irr))
        assert abs(float(jloss) - loss) <= IRREGULAR_REL_TOL * abs(float(jloss))

    def batches(stop=None):
        for k in range(6):
            if k == stop:
                raise RuntimeError("simulated crash")
            r = np.random.RandomState(100 + k)
            pos = np.sort(r.choice(np.arange(200, S - 900), size=cap, replace=False)
                          ).astype(np.int32)
            yield (raw, res, jnp.asarray(pos), jnp.asarray(mask),
                   jnp.asarray((r.rand(cap) > 0.5).astype(np.float32)))

    mgr = JaxCheckpointManager(str(tmp_path))
    with pytest.raises(RuntimeError):
        jax_run_resumable(mgr, lambda: init_irr(jax.random.PRNGKey(2)), irr_step, batches(4),
                          save_every=2)
    assert out["crashed"] and out["crashed_checkpoints"] == mgr.all_steps() == [2, 4]
    _, steps = jax_run_resumable(mgr, lambda: init_irr(jax.random.PRNGKey(2)), irr_step,
                                 batches(), save_every=2)
    assert out["resumed_at"] == steps == 6
    assert out["bit_identical"]
    for k, v in out["reference_params"].items():
        assert np.array_equal(out["resumed_params"][k], v)
    assert out["k1_launches"] == 0


@pytest.mark.parametrize("shards", [8])
def test_sharded_long_recording_matches_the_jax_sharded_ingest(shards):
    from eeg_dataanalysispackage_tpu.io.brainvision import Marker as JaxMarker
    from eeg_dataanalysispackage_tpu.parallel import mesh as jax_mesh
    from eeg_dataanalysispackage_tpu.parallel import sharded_ingest as jax_sharded

    block = 4096
    T = shards * block
    out = sharded_long_recording.run(device="cpu", shards=shards, block=block,
                                     key=_jax_params(0))
    assert out["shards"] == shards and out["halo_windows"] >= 1
    feats, plan, raw, res = out["features"], out["plan"], out["raw"], out["resolutions"]
    jmarkers = [JaxMarker(m.name, m.kind, m.stimulus, m.position) for m in out["markers"]]
    if len(jax.devices()) >= shards:
        jm = jax_mesh.make_mesh(shards, axes=(jax_mesh.TIME_AXIS,))
        jplan = jax_sharded.plan_sharded_ingest(jmarkers, guessed_number=4, n_samples=T,
                                                n_shards=shards, block=block)
        theirs = np.asarray(jax_sharded.make_sharded_ingest(jm)(
            jax_sharded.stage_recording_int16(raw, jm), res, jplan))
        np.testing.assert_array_equal(plan.targets, jplan.targets)
    else:  # the JAX package's unsharded block featurizer, its own tests' reference
        base = jax_device_ingest.plan_ingest(jmarkers, 4, T)
        theirs = np.asarray(jax_device_ingest.make_block_ingest_featurizer()(
            jnp.asarray(raw), jnp.asarray(res), jnp.asarray(base.positions),
            jnp.asarray(base.mask)))[base.mask]
        np.testing.assert_array_equal(plan.targets, base.targets)
    assert feats.shape == theirs.shape
    np.testing.assert_allclose(feats.numpy(), theirs, rtol=0, atol=BLOCK_TOL)
    # bit-equal to the port's unsharded rows on the same plan
    base = device_ingest.plan_ingest(out["markers"], 4, T)
    unsharded = ingest_cuda.make_cuda_ingest_featurizer()(
        torch.from_numpy(raw), torch.from_numpy(res), base.positions, base.mask)
    assert torch.equal(feats, unsharded[: base.n_kept])
    # the JAX SGD on the same rows
    w = np.asarray(jax_sgd.train_linear(feats.numpy(), plan.targets.astype(np.float32),
                                        jax_sgd.SGDConfig(num_iterations=50)))
    np.testing.assert_allclose(out["weights"].numpy(), w, rtol=0, atol=F32_TOL)
    # the raw-stream step from the JAX package's weights
    rng = np.random.RandomState(0)
    rng.randint(-3000, 3000, size=(3, T))
    rng.randint(-150, 150, size=np.arange(200, T - 1000, 800).shape)
    n_ep = min(512, (T - 200 - 8192) // 800)
    labels = (rng.rand(n_ep) > 0.5).astype(np.float32)
    init_state, step = jax_train.make_raw_train_step(800, n_ep, donate_state=False)
    state = init_state(jax.random.PRNGKey(0))
    for loss in out["losses"]:
        state, jloss = step(state, jnp.asarray(raw), jnp.asarray(res), jnp.asarray(labels),
                            jnp.ones((n_ep,), jnp.float32), 200)
        assert abs(float(jloss) - loss) <= RAW_LOSS_TOL
    assert out["k1_launches"] == 0


def test_stream_continuous_matches_the_jax_extractors():
    from eeg_dataanalysispackage_tpu.parallel import mesh as jax_mesh
    from eeg_dataanalysispackage_tpu.parallel import streaming as jax_streaming

    C, T, shards = 4, 8 * 2048, 8
    out = stream_continuous.run(device="cpu", channels=C, samples=T, block=4096, shards=shards)
    raw = np.random.RandomState(0).randint(-3000, 3000, size=(C, T)).astype(np.int16)
    res = np.full(C, 0.1, np.float32)
    blocked, mesh_rows = out["blocked"], out["mesh"].numpy()
    assert blocked.shape == ((T - 512) // 256 + 1, C * 16) and mesh_rows.shape == (T // 256, C * 16)
    np.testing.assert_allclose(blocked, jax_streaming.blocked_features(
        raw, block=4096, resolutions=res), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(mesh_rows[: len(blocked)], blocked, rtol=0, atol=F32_TOL)
    if len(jax.devices()) >= shards:
        jm = jax_mesh.make_mesh(shards, axes=(jax_mesh.TIME_AXIS,))
        signal = raw.astype(np.float32) * res[:, None]
        theirs = np.asarray(jax_streaming.make_streaming_extractor(jm, window=512, stride=256)(
            jax_streaming.stage_recording(signal, jm)))
        np.testing.assert_allclose(mesh_rows, theirs, rtol=0, atol=F32_TOL)


def test_mllib_migration_predicts_as_the_jax_classes(tmp_path):
    from eeg_dataanalysispackage_tpu.models.linear import LogisticRegressionClassifier
    from eeg_dataanalysispackage_tpu.models.trees import RandomForestClassifier

    out = mllib_migration.run(device="cpu", work=str(tmp_path))
    assert out["bit_equal"]
    rng = np.random.RandomState(0)
    X = rng.randn(256, 48)
    y = (X @ rng.randn(48) + 0.2 > 0).astype(np.float64)
    clf = LogisticRegressionClassifier()
    clf.load(out["legacy_dir"])
    np.testing.assert_array_equal(out["imported_predictions"], np.asarray(clf.predict(X)))
    rf = RandomForestClassifier()
    rf.set_config(mllib_migration.FOREST_CONFIG)
    rf.fit(X, y)
    np.testing.assert_array_equal(out["forest_predictions"], np.asarray(rf.predict(X)))
    assert out["forest_accuracy"] == float((np.asarray(rf.predict(X)) == y).mean())
    rf2 = RandomForestClassifier()
    rf2.load(out["export_dir"])
    np.testing.assert_array_equal(out["round_trip_predictions"], np.asarray(rf2.predict(X)))
    # the two packages' round trips disagree with their own forests on the
    # same rows: the 5-5 tied votes, which the forest predicts 0 and
    # MLlib's Vote combining 1
    assert out["round_trip_agreement"] == float(
        (np.asarray(rf2.predict(X)) == np.asarray(rf.predict(X))).mean())


# -- main(): the printed lines, and no card without --device ----------------------------------

_NUM = r"-?\d+\.\d+"
MAIN_CASES = {
    "train_p300": ([], [
        r"query-string pipeline:", r"Number of patterns: \d+",
        r"fused device path: Number of patterns: \d+",
        r"K1's plain PyTorch version on cpu \(no kernel launch\)"]),
    "fused_ingest": (["--n", "8"], [
        rf"plain version : \(8, 48\)  norm\[0\]={_NUM}",
        r"K1 kernel     : \(8, 48\)  max\|Δ\| vs plain = \S+",
        r"regular train : \(8, 48\)  \(K1 at first \+ k\*stride, formulation 'reshape'\)",
        r"K1's plain PyTorch version on cpu \(no kernel launch\)"]),
    "raw_stream_training": (["--n", "8", "--cap", "16"], [
        *(rf"regular raw-stream step {i}: loss {_NUM}" for i in range(3)),
        *(rf"irregular raw-stream step {i}: loss {_NUM}" for i in range(3)),
        r"crashed at step 4; checkpoints: \[2, 4\]", r"resumed and finished at step 6",
        r"resumed == uninterrupted \(bit-identical params\): True",
        r"K1's plain PyTorch version on cpu \(no kernel launch\)"]),
    "sharded_long_recording": (["--shards", "2", "--block", "8192"], [
        r"\d+ markers -> \d+ balanced epochs featurized across 2 time shards: \(\d+, 48\)",
        rf"logreg on sharded-ingest features: train accuracy {_NUM}",
        *(rf"raw-stream train step {i}: loss {_NUM}" for i in range(3)),
        r"K1's plain PyTorch version on cpu \(no kernel launch\)"]),
    "stream_continuous": (["--channels", "2", "--samples", "8192"], [
        r"blocked streaming: \(31, 32\) features from 2ch x 8192 samples",
        r"mesh streaming over 8 device\(s\): \(32, 32\) \(the last 1 row\(s\) wrap the ring\)",
        r"no hand-written kernel on this path: one torch.matmul a window block on cpu"]),
    "mllib_migration": ([], [
        r"imported legacy_logreg_model: \d+/256 positive, bit-equal to the JVM's "
        r"double-margin predictions",
        rf"exported rf \(train acc {_NUM}\) -> \S+exported_rf_model; round-trip prediction "
        rf"agreement {_NUM}",
        r"no kernel on this path \(rows on cpu\)"]),
}
MODULES = {"train_p300": train_p300, "fused_ingest": fused_ingest,
           "raw_stream_training": raw_stream_training,
           "sharded_long_recording": sharded_long_recording,
           "stream_continuous": stream_continuous, "mllib_migration": mllib_migration}


def _argv(name, session):
    return [session] if name == "train_p300" else []


@pytest.mark.parametrize("name", sorted(MAIN_CASES))
def test_main_prints_the_walkthrough_lines(name, session):
    extra, patterns = MAIN_CASES[name]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert MODULES[name].main(_argv(name, session) + ["--device", "cpu"] + extra) == 0
    lines = [line for line in buf.getvalue().splitlines() if line.strip()]
    starts = [i for i, line in enumerate(lines)
              if any(re.fullmatch(p, line) for p in patterns)]
    matched = [next(p for p in patterns if re.fullmatch(p, lines[i])) for i in starts]
    assert matched == patterns, lines  # every line, once, in the JAX script's order


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_without_device_raises_without_a_card(name, session):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: no --device runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        MODULES[name].main(_argv(name, session))


def test_train_p300_without_an_info_file_exits_with_the_jax_message(tmp_path):
    with pytest.raises(SystemExit, match="info.txt not found: "):
        train_p300.main([str(tmp_path / "absent.txt"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="info.txt not found: "):
        train_p300.main(["--device", "cpu"])
