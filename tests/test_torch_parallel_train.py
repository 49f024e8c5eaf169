"""The port's data-parallel trainers (``parallel/train.py``, the ``mesh=``
of ``models/sgd.train_linear``, ``io.staging.prefetch(mesh=)``) against
the JAX package's, on the CPU (its bank kernel in Pallas interpret mode,
as its own tests run it).

Tolerances, each measured on these inputs:

- data-parallel SGD on 8 logical shards against the port's unmeshed run
  and the JAX package's unmeshed run: 2e-5, the JAX test's own
  (``tests/test_parallel.py``; the shard gradients add in shard order,
  XLA's psum in its own; measured 6.0e-8 against both);
- ``make_raw_train_step``'s rows (the regular-train featurizer, every
  formulation name through the one kernel) against the JAX package's
  ``bank`` regular featurizer: 5e-5, the bank formulation's numerics
  (measured 3.9e-7); the raw step equal to ingest + feature step;
- ``make_irregular_bank_train_step`` over 10 steps from the JAX
  package's own initial weights, carried over: losses within 1e-6 at
  ``bank128`` (measured 1.2e-7) and within 1e-4 at ``bank128_bf16``
  (measured 4.1e-5: the port's bf16 instantiation rounds the centred
  samples, the JAX bank kernel its slab-mean-centred ones, 2e-3 apart by
  design, ROADMAP.md);
- ``make_feature_train_step`` / ``make_train_step`` /
  ``make_compact_train_step`` / ``make_irregular_train_step`` from the
  same weights: losses within 1e-6 relative of the JAX package's, and
  a data-parallel step on 4 shards within 1e-6 of the unmeshed one;
- ``train_over_recordings``: losses and weights equal with ``overlap``
  true and false at buffer depths 1 and 2, and within 1e-5 of the JAX
  package's serial run;
- ``staging.prefetch(mesh=)``: batches padded and split as
  ``shard_batch_with_mask`` pads them (exact), in order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.models import sgd as jax_sgd
from eeg_dataanalysispackage_tpu.ops import device_ingest as jax_device_ingest
from eeg_dataanalysispackage_tpu.parallel import train as jax_train
from eeg_dataanalysispackage_tpu_torch.io import staging
from eeg_dataanalysispackage_tpu_torch.models import sgd
from eeg_dataanalysispackage_tpu_torch.obs import chaos
from eeg_dataanalysispackage_tpu_torch.ops import device_ingest, ingest_cuda
from eeg_dataanalysispackage_tpu_torch.parallel import mesh as pmesh, train as ptrain

RES = np.array([0.1, 0.1, 0.2], np.float32)


@pytest.fixture(scope="module")
def mesh8():
    return pmesh.make_mesh(8, device="cpu")


def _jax_params(feature_dim=48, seed=0):
    return {k: np.asarray(v) for k, v in
            jax_train.init_mlp_params(jax.random.PRNGKey(seed),
                                      sizes=(feature_dim, 64, 2)).items()}


# -- data-parallel SGD ---------------------------------------------------------------


def test_data_parallel_sgd_matches_single_device(mesh8):
    rng = np.random.RandomState(0)
    x = rng.randn(203, 16).astype(np.float32)  # deliberately not /8
    y = (x @ rng.randn(16) > 0).astype(np.float32)
    w_dist = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y),
                              sgd.SGDConfig(num_iterations=40), mesh=mesh8)
    w_single = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y),
                                sgd.SGDConfig(num_iterations=40))
    theirs = np.asarray(jax_sgd.train_linear(x, y, jax_sgd.SGDConfig(num_iterations=40)))
    np.testing.assert_allclose(w_dist.numpy(), w_single.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(w_dist.numpy(), theirs, rtol=0, atol=2e-5)
    assert ((x @ w_dist.numpy() >= 0) == y).mean() > 0.9


def test_data_parallel_sgd_minibatch_path(mesh8):
    rng = np.random.RandomState(1)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    cfg = sgd.SGDConfig(num_iterations=30, mini_batch_fraction=0.5)
    w = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y), cfg, mesh=mesh8)
    assert ((x @ w.numpy() >= 0) == y).mean() > 0.85
    # the draws span the padded rows, as the JAX package's do: 64 rows on 8
    # shards pad nothing, so the run is the unmeshed one's
    w1 = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y), cfg)
    np.testing.assert_allclose(w.numpy(), w1.numpy(), rtol=0, atol=2e-5)


def test_data_parallel_elastic_sgd_equals_data_parallel_sgd(mesh8, tmp_path):
    from eeg_dataanalysispackage_tpu_torch.checkpoint.manager import CheckpointManager

    rng = np.random.RandomState(2)
    x = rng.randn(50, 6).astype(np.float32)
    y = (x[:, 1] > 0).astype(np.float32)
    cfg = sgd.SGDConfig(num_iterations=25, convergence_tol=0.0)
    want = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y), cfg, mesh=mesh8)
    with chaos.faults("device.step:once@2"):
        got = sgd.train_linear_elastic(torch.from_numpy(x), torch.from_numpy(y), cfg,
                                       CheckpointManager(str(tmp_path)), chunk_iters=10,
                                       mesh=mesh8, probe_on_failure=False)
    assert torch.equal(got, want)


# -- the regular-train featurizer and the raw step (K2's first call site) ------------


@pytest.fixture(scope="module")
def regular_case():
    rng = np.random.RandomState(0)
    n, stride, first = 32, 800, 150
    S = 200 + n * stride + 8192
    raw = (rng.randint(-3000, 3000, size=(3, S)) + np.array([[1500], [-900], [400]])
           ).astype(np.int16)
    labels = rng.randint(0, 2, size=n).astype(np.float32)
    bank = np.asarray(jax_device_ingest.make_regular_ingest_featurizer(
        stride, n, formulation="bank")(jnp.asarray(raw), jnp.asarray(RES), first))
    return raw, labels, n, stride, first, bank


@pytest.mark.parametrize("formulation", ["auto", "reshape", "conv", "phase", "partial", "bank"])
def test_regular_featurizer_rows_match_the_jax_bank_formulation(regular_case, formulation):
    raw, _labels, n, stride, first, bank = regular_case
    ing = device_ingest.make_regular_ingest_featurizer(stride, n, formulation=formulation,
                                                       device="cpu")
    assert ing.formulation == ("reshape" if formulation == "auto" else formulation)
    rows = ing(torch.from_numpy(raw), torch.from_numpy(RES), first)
    np.testing.assert_allclose(rows.numpy(), bank, rtol=0, atol=5e-5)
    # the rows are the fused kernel's at first + k*stride
    want = ingest_cuda.ingest_features_cuda(torch.from_numpy(raw), torch.from_numpy(RES),
                                            first + stride * np.arange(n))
    assert torch.equal(rows, want)


def test_regular_featurizer_checks():
    assert device_ingest.resolve_regular_formulation("auto", 800, "cuda") == "phase"
    assert device_ingest.resolve_regular_formulation("auto", 801, "cuda") == "conv"
    assert jax_device_ingest.resolve_regular_formulation("phase", 800) == "phase"
    with pytest.raises(ValueError, match="unknown regular-ingest formulation"):
        device_ingest.make_regular_ingest_featurizer(800, 4, formulation="gather", device="cpu")
    with pytest.raises(ValueError, match="stride >= 787"):
        device_ingest.make_regular_ingest_featurizer(700, 4, device="cpu")
    ing = device_ingest.make_regular_ingest_featurizer(800, 4, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        ing(torch.zeros((3, 3000), dtype=torch.int16), torch.from_numpy(RES), 150)
    with pytest.raises(ValueError, match="do not fit"):
        ing(torch.zeros((3, 9000), dtype=torch.int16), torch.from_numpy(RES), 50)


def test_raw_train_step_matches_feature_step_composition(regular_case):
    """make_raw_train_step == fused ingest + make_feature_train_step
    (identical losses and weights), and the loss moves; the JAX
    package's raw step from the same weights, within 1e-5."""
    raw, labels, n, stride, first, _bank = regular_case
    mask = np.ones(n, np.float32)
    params = _jax_params()
    init_raw, raw_step = ptrain.make_raw_train_step(stride, n, formulation="bank",
                                                    device="cpu")
    state = init_raw(params)
    losses = []
    for _ in range(5):
        state, loss = raw_step(state, torch.from_numpy(raw), RES, labels, mask, first)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    feats = device_ingest.make_regular_ingest_featurizer(stride, n, device="cpu")(
        torch.from_numpy(raw), torch.from_numpy(RES), first)
    init_f, feat_step = ptrain.make_feature_train_step(device="cpu")
    state_f = init_f(params)
    for i in range(5):
        state_f, loss_f = feat_step(state_f, feats, labels, mask)
        assert float(loss_f) == losses[i]
    for k in params:
        assert torch.equal(state_f["params"][k], state["params"][k])
    init_j, jstep = jax_train.make_raw_train_step(stride, n, formulation="bank",
                                                  donate_state=False)
    jstate = init_j(jax.random.PRNGKey(0))
    for i in range(5):
        jstate, jloss = jstep(jstate, jnp.asarray(raw), jnp.asarray(RES), jnp.asarray(labels),
                              jnp.asarray(mask), first)
        assert abs(float(jloss) - losses[i]) <= 1e-5


# -- the irregular steps (K2's second call site) ----------------------------------------


def _irregular_case(n=70):
    rng = np.random.RandomState(5)
    S = 80_000
    raw = rng.randint(-3000, 3000, size=(3, S)).astype(np.int16)
    positions = np.sort(rng.choice(np.arange(200, S - 900), size=n, replace=False))
    cap = ((n + 63) // 64) * 64
    pos_pad = np.zeros(cap, np.int32)
    pos_pad[:n] = positions
    mask = np.zeros(cap, bool)
    mask[:n] = True
    labels = np.pad(rng.randint(0, 2, size=n).astype(np.float32), (0, cap - n))
    return raw, pos_pad, mask, labels


@pytest.mark.parametrize("mode,tol", [("bank128", 1e-6), ("bank128_bf16", 1e-4)])
def test_irregular_bank_step_losses_match_the_jax_package(mode, tol):
    raw, pos, mask, labels = _irregular_case()
    n = int(mask.sum())
    init_j, jstep = jax_train.make_irregular_bank_train_step(pos[:n], mode=mode,
                                                             donate_state=False)
    jstate = init_j(jax.random.PRNGKey(0))
    params = {k: np.asarray(v) for k, v in jstate["params"].items()}
    init_p, pstep = ptrain.make_irregular_bank_train_step(pos[:n], mode=mode, device="cpu")
    state = init_p(params)
    before = ingest_cuda.LAUNCHES
    for _ in range(10):
        jstate, jloss = jstep(jstate, jnp.asarray(raw), jnp.asarray(RES),
                              jnp.asarray(labels[:n]))
        state, loss = pstep(state, torch.from_numpy(raw), RES, labels[:n])
        assert abs(float(loss) - float(jloss)) <= tol
    assert ingest_cuda.LAUNCHES == before  # the CPU runs the plain version
    with pytest.raises(ValueError, match="built for 3 channels"):
        pstep(state, torch.from_numpy(raw[:2]), RES[:2], labels[:n])
    with pytest.raises(ValueError, match="supports"):
        ptrain.make_irregular_bank_train_step(pos[:n], mode="bank256", device="cpu")


def test_irregular_bank_step_nondefault_feature_size_sizes_the_mlp():
    raw, pos, mask, labels = _irregular_case()
    n = int(mask.sum())
    init_k, step_k = ptrain.make_irregular_bank_train_step(pos[:n], feature_size=8,
                                                           device="cpu")
    state = init_k(0)
    assert state["params"]["w0"].shape[0] == 3 * 8
    _, loss = step_k(state, torch.from_numpy(raw), RES, labels[:n])
    assert np.isfinite(float(loss))


def test_irregular_step_matches_the_jax_package_and_masks_padded_rows():
    raw, pos, mask, labels = _irregular_case()
    params = _jax_params()
    init_state, step = ptrain.make_irregular_train_step(device="cpu")
    state = init_state(params)
    new, loss = step(state, torch.from_numpy(raw), RES, pos, mask, labels)
    init_j, jstep = jax_train.make_irregular_train_step(donate_state=False)
    _, jloss = jstep(init_j(jax.random.PRNGKey(0)), jnp.asarray(raw), jnp.asarray(RES),
                     jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(labels))
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    # flipping the labels of masked-out rows changes nothing, and the
    # state passed in is not changed in place
    flipped = labels.copy()
    flipped[~mask] = 1.0 - flipped[~mask]
    _, loss_b = step(state, torch.from_numpy(raw), RES, pos, mask, flipped)
    assert float(loss_b) == float(loss)
    for k in params:
        np.testing.assert_array_equal(state["params"][k].numpy(), params[k])
        assert not torch.equal(new["params"][k], state["params"][k]) or k.startswith("b")


# -- the epoch steps and the data-parallel MLP step -----------------------------------------


def test_train_and_compact_steps_match_the_jax_package():
    rng = np.random.RandomState(3)
    n = 32
    epochs = rng.randn(n, 3, 1000).astype(np.float32) * 40.0
    labels = rng.randint(0, 2, size=n).astype(np.float32)
    mask = np.ones(n, np.float32)
    params = _jax_params()
    init_f, step_f = ptrain.make_train_step(device="cpu")
    _, loss_full = step_f(init_f(params), epochs, labels, mask)
    init_c, step_c = ptrain.make_compact_train_step(device="cpu")
    sliced = np.ascontiguousarray(epochs[:, :, 175:175 + 512])
    _, loss_compact = step_c(init_c(params), sliced, labels, mask)
    assert abs(float(loss_compact) - float(loss_full)) <= 1e-6
    init_j, jstep = jax_train.make_train_step(donate_state=False)
    _, jloss = jstep(init_j(jax.random.PRNGKey(0)), jnp.asarray(epochs), jnp.asarray(labels),
                     jnp.asarray(mask))
    assert abs(float(loss_full) - float(jloss)) <= 1e-6 * abs(float(jloss))
    with pytest.raises(ValueError, match="epoch_size"):
        step_c(init_c(params), epochs, labels, mask)
    assert ptrain.forward_step(init_f(params)["params"],
                               torch.from_numpy(epochs)).shape == (n,)


def test_data_parallel_feature_step_equals_the_unmeshed_step():
    rng = np.random.RandomState(4)
    x = rng.randn(37, 48).astype(np.float32)
    y = rng.randint(0, 2, size=37).astype(np.float32)
    params = _jax_params()
    mesh = pmesh.make_mesh(4, device="cpu")
    init_m, step_m = ptrain.make_feature_train_step(mesh)
    init_s, step_s = ptrain.make_feature_train_step(device="cpu")
    sm, ss = init_m(params), init_s(params)
    xs, ys, mask = ptrain.stage_batch(x, y, mesh)
    assert xs.shape == (40, 48) and float(mask.sum()) == 37.0
    for _ in range(5):
        sm, loss_m = step_m(sm, xs, ys, mask)
        ss, loss_s = step_s(ss, x, y, np.ones(37, np.float32))
        assert abs(float(loss_m) - float(loss_s)) <= 1e-6
    for k in params:
        np.testing.assert_allclose(sm["params"][k].numpy(), ss["params"][k].numpy(), rtol=0,
                                   atol=1e-6)
    # plain tensors are split by the step itself
    sp, loss_p = step_m(init_m(params), x, y, np.ones(37, np.float32))
    _, loss_1 = step_s(init_s(params), x, y, np.ones(37, np.float32))
    assert abs(float(loss_p) - float(loss_1)) <= 1e-6


def test_steps_fire_the_device_step_chaos_point():
    init_state, step = ptrain.make_feature_train_step(device="cpu")
    state = init_state(0)
    x = np.zeros((4, 48), np.float32)
    with chaos.faults("device.step:once@2"):
        state, _ = step(state, x, np.zeros(4, np.float32), np.ones(4, np.float32))
        with pytest.raises(chaos.ChaosInjectedError):
            step(state, x, np.zeros(4, np.float32), np.ones(4, np.float32))


def test_init_mlp_params_shapes_and_scale():
    p = ptrain.init_mlp_params(0, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w0": (48, 64), "b0": (64,), "w1": (64, 2), "b1": (2,)}
    assert torch.equal(p["w0"], ptrain.init_mlp_params(0, device="cpu")["w0"])
    assert 0.1 < float(p["w0"].std()) < 0.3 and float(p["b0"].abs().sum()) == 0.0


# -- overlapped raw-stream training ---------------------------------------------------------


def _training_recordings(n_rec=3, n_markers=40, stride=750):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n_rec):
        S = 200 + n_markers * stride + 1000
        raw = rng.randint(-3000, 3000, size=(3, S), dtype=np.int16)
        positions = np.clip(np.arange(n_markers, dtype=np.int64) * stride + 200
                            + rng.randint(-200, 200, size=n_markers), 100, S - 800)
        cap = ((n_markers + 63) // 64) * 64
        pos = np.zeros(cap, np.int32)
        pos[:n_markers] = positions
        mask = np.zeros(cap, bool)
        mask[:n_markers] = True
        labels = np.zeros(cap, np.float32)
        labels[:n_markers] = rng.randint(0, 2, size=n_markers)
        out.append((raw, RES, pos, mask, labels))
    return out


def test_train_over_recordings_overlap_parity():
    recs = _training_recordings()
    params = _jax_params()
    init_state, step = ptrain.make_feature_train_step(device="cpu")

    def run(overlap, buffer_size=None):
        return ptrain.train_over_recordings(init_state(params), step, recs, overlap=overlap,
                                            buffer_size=buffer_size)

    state_serial, losses_serial = run(False)
    for depth in (1, 2):
        state_ov, losses_ov = run(True, buffer_size=depth)
        assert losses_ov == losses_serial, depth
        for k in params:
            assert torch.equal(state_serial["params"][k], state_ov["params"][k]), (depth, k)
    init_j, jstep = jax_train.make_feature_train_step(donate_state=False)
    _, jlosses = jax_train.train_over_recordings(init_j(jax.random.PRNGKey(0)), jstep, recs,
                                                 overlap=False)
    np.testing.assert_allclose(losses_serial, jlosses, rtol=0, atol=1e-5)


def test_prefetch_with_a_mesh_pads_and_splits_each_batch():
    mesh = pmesh.make_mesh(4, device="cpu")
    rng = np.random.RandomState(8)
    batches = [(rng.randn(n, 3).astype(np.float32), rng.randint(0, 2, n)) for n in (10, 8, 3)]
    got = list(staging.prefetch(iter(batches), mesh=mesh, buffer_size=2))
    assert len(got) == 3
    for (x, y), (xs, ys, mask) in zip(batches, got):
        want = pmesh.shard_batch_with_mask(mesh, x, y)
        for a, b in zip((xs, ys, mask), want):
            assert len(a.shards) == 4
            assert torch.equal(a.gather(), b.gather())
        assert float(mask.sum()) == len(y)
    bare = list(staging.prefetch(iter(batches[:1]), mesh=mesh, with_mask=False))
    assert len(bare[0]) == 2 and bare[0][0].shape == (12, 3)
