"""Every public name of the JAX package has its place in the port.

For each JAX module with a twin in the port (same relative path), both
are parsed with ``ast``; every public top-level function and class, every
public method of a public class, and every UPPER_CASE top-level constant
of the JAX module must be in the twin, or in :data:`ELSEWHERE` (the port
module and name where it lives, checked to exist), or in
:data:`BY_DESIGN` with a one-line reason. Each map's entries must be
absent from the twin, so neither map outlives the code. One case a
module pair. The second half holds the names this check brought over
against the JAX package on the same inputs.
"""

import ast
import os
import re

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, "eeg_dataanalysispackage_tpu")
PORT = os.path.join(REPO, "eeg_dataanalysispackage_tpu_torch")
_CONST = re.compile(r"^[A-Z][A-Z0-9_]*$")

#: (JAX module, name) -> (port module, name) where the port keeps it
ELSEWHERE = {
    ("checkpoint/manager.py", "atomic_write_bytes"): ("io/modelfiles.py", "atomic_write_bytes"),
    ("checkpoint/manager.py", "atomic_write_text"): ("scheduler/journal.py", "_atomic_write_text"),
    ("ops/dwt.py", "dwt_coefficients"): ("ops/dwt_host.py", "dwt_coefficients"),
    ("pipeline/builder.py", "PipelineBuilder.seizure_weights"):
        ("models/seizure.py", "seizure_weights"),
}

_TPU = ("TPU evidence: the TPU sweep artifacts' decision table "
        "(no port default comes from TPU numbers)")
_XLA_DECODE = ("an XLA formulation of the decode rung (slice scan, bank128 VMEM cut); "
               "the port's fused path is K1")
_XLA_BLOCK = ("an XLA formulation of the fused ingest (block and classed gathers, the device "
              "epocher); the port's fused path is K1")

#: (JAX module, name) -> why the port has no such name
BY_DESIGN = {
    ("ops/decode_ingest.py", "BANK128_FLIP_RATIO"): _TPU,
    ("ops/decode_ingest.py", "CHIP_BLOCK_EPS"): _TPU,
    ("ops/decode_ingest.py", "CHIP_GATHER_EPS"): _TPU,
    ("ops/decode_ingest.py", "accelerator_decision"): _TPU,
    ("ops/decode_ingest.py", "default_accelerator_backend"): _TPU,
    ("ops/decode_ingest.py", "DECODE_FORMULATIONS"): _XLA_DECODE,
    ("ops/decode_ingest.py", "DEFAULT_TILE"): _XLA_DECODE,
    ("ops/decode_ingest.py", "ENV_FORMULATION"): _XLA_DECODE,
    ("ops/decode_ingest.py", "default_formulation"): _XLA_DECODE,
    ("ops/decode_ingest.py", "default_splits"): _XLA_DECODE,
    ("ops/decode_ingest.py", "bucket_capacity"): "XLA jit-shape bucketing; K1 takes any capacity",
    ("ops/decode_ingest.py", "make_decode_ingest_featurizer"): _XLA_DECODE,
    ("ops/decode_ingest.py", "plan_decode_windows"): _XLA_DECODE,
    ("ops/device_ingest.py", "BlockClassPlan"): _XLA_BLOCK,
    ("ops/device_ingest.py", "BlockClassPlan.n_classes"): _XLA_BLOCK,
    ("ops/device_ingest.py", "BlockClassPlan.slots_per_class"): _XLA_BLOCK,
    ("ops/device_ingest.py", "cached_block_class_plan"): _XLA_BLOCK,
    ("ops/device_ingest.py", "plan_block_classes"): _XLA_BLOCK,
    ("ops/device_ingest.py", "make_block_ingest_featurizer"): _XLA_BLOCK,
    ("ops/device_ingest.py", "make_classed_block_ingest_featurizer"): _XLA_BLOCK,
    ("ops/device_ingest.py", "make_device_ingest_featurizer"): _XLA_BLOCK,
    ("ops/device_ingest.py", "make_device_epocher"): _XLA_BLOCK,
    ("ops/device_ingest.py", "ingest_recording"): _XLA_BLOCK,
    ("ops/device_ingest.py", "default_fused_backend"):
        "picks among the XLA rungs by platform and TPU evidence; the port runs K1",
    ("ops/quant.py", "WEIGHTS_QUANT_FLIP_RATIO"): _TPU,
    ("ops/quant.py", "accelerator_decision"): _TPU,
    ("ops/serve_mega.py", "MEGA_FLIP_RATIO"): _TPU,
    ("ops/serve_mega.py", "accelerator_decision"): _TPU,
    ("ops/serve_mega.py", "default_engine_rung"):
        "resolves 'auto' from the TPU decision table; the port's engine picks by device",
    ("ops/serve_mega.py", "LOWERINGS"): "Pallas or XLA lowering of the megakernel (XLA/Pallas only)",
    ("ops/serve_mega.py", "default_lowering"): "Pallas or XLA lowering (XLA/Pallas only)",
    ("ops/serve_mega.py", "MEGA_TILE"): "the Pallas grid's windows a step (Pallas only)",
    ("serve/multiplex.py", "MULTIPLEX_FLIP_RATIO"): _TPU,
    ("serve/multiplex.py", "accelerator_decision"): _TPU,
    ("obs/report.py", "CompilationMonitor"): "XLA compile accounting (no compiler to monitor)",
    ("obs/report.py", "CompilationMonitor.snapshot"): "XLA compile accounting",
    ("parallel/mesh.py", "batch_sharding"): "an XLA NamedSharding (the port's shards are tensors)",
    ("parallel/mesh.py", "replicated"): "an XLA NamedSharding",
    ("parallel/pod.py", "exchange_collective_hlo"): "inspects XLA HLO for the collective",
    ("models/sgd.py", "sgd_invocation"):
        "(jitted, args, kwargs) for AOT lowering of the XLA scan; the port's loop lowers nothing",
    ("io/provider.py", "FUSED_DEGRADATION_LADDER"): "the degradation ladder (the port has none)",
    ("io/provider.py", "degradation_ladder"): "the degradation ladder (the port has none)",
}


def public_names(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{sub.name}" for sub in node.body
                           if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                           and not sub.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(n.id for t in targets for n in ast.walk(t)
                       if isinstance(n, ast.Name) and _CONST.match(n.id))
    return out


def bound_names(path):
    """Every name a module binds at top level, imports included."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    out = public_names(path)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            out.update(n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name))
    return out


def twins():
    out = []
    for root, _dirs, files in os.walk(JAX):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name), JAX)
                if os.path.exists(os.path.join(PORT, rel)):
                    out.append(rel)
    return sorted(out)


@pytest.mark.parametrize("rel", twins())
def test_every_public_name_has_its_place(rel):
    jax_names = public_names(os.path.join(JAX, rel))
    port_names = bound_names(os.path.join(PORT, rel))
    missing = jax_names - port_names
    unplaced = sorted(n for n in missing if (rel, n) not in ELSEWHERE and (rel, n) not in BY_DESIGN)
    assert not unplaced, f"{rel}: no twin, no home, no reason for {unplaced}"
    for (mod, name), (where, there) in ELSEWHERE.items():
        if mod == rel:
            assert name in missing, f"{rel}:{name} is in the twin; drop it from ELSEWHERE"
            assert there in bound_names(os.path.join(PORT, where)), (where, there)
    for (mod, name), reason in BY_DESIGN.items():
        if mod == rel:
            assert name in jax_names and name in missing, f"{rel}:{name} ({reason})"


def test_the_sweep_walks_every_twin():
    assert len(twins()) >= 85
    assert {mod for mod, _ in list(ELSEWHERE) + list(BY_DESIGN)} <= set(twins())


# -- the names brought over, against the JAX package


@pytest.mark.parametrize("query,name", [
    ("a=1&faults=x:once@1;y:p=0.5&b=", "faults"), ("a=1&b=", "b"), ("a=1", "faults"),
    ("fe=dwt-8:level=5=x&a=1", "fe"), ("fa=1&f=2", "f"),
])
def test_get_raw_param(query, name):
    from eeg_dataanalysispackage_tpu.pipeline import builder as jax_builder
    from eeg_dataanalysispackage_tpu_torch.pipeline import builder

    assert builder.get_raw_param(query, name) == jax_builder.get_raw_param(query, name)


def test_registry_names_and_register(monkeypatch):
    from eeg_dataanalysispackage_tpu.models import registry as jax_registry
    from eeg_dataanalysispackage_tpu_torch.models import linear, registry

    assert registry.names() == jax_registry.names()
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    registry.register("logreg-2", linear.LogisticRegressionClassifier)
    assert "logreg-2" in registry.names()
    assert isinstance(registry.create("logreg-2"), linear.LogisticRegressionClassifier)


def test_classification_statistics_add():
    from eeg_dataanalysispackage_tpu.models.stats import ClassificationStatistics as Jax
    from eeg_dataanalysispackage_tpu_torch.models.stats import ClassificationStatistics

    rng = np.random.default_rng(0)
    real, expected = rng.random(40) * 1.4 - 0.2, rng.integers(0, 3, 40).astype(float)
    got, want = ClassificationStatistics(), Jax()
    for r, e in zip(real.tolist(), expected.tolist()):
        got.add(r, e)
        want.add(r, e)
    assert str(got) == str(want)
    assert vars(got) == {k: v for k, v in vars(want).items() if k in vars(got)}


def test_predict_margin():
    import jax.numpy as jnp

    from eeg_dataanalysispackage_tpu.models import sgd as jax_sgd
    from eeg_dataanalysispackage_tpu_torch.models import sgd

    rng = np.random.default_rng(1)
    x, w = rng.standard_normal((33, 48)).astype(np.float32), rng.standard_normal(48).astype(np.float32)
    got = sgd.predict_margin(torch.tensor(x), torch.tensor(w)).numpy()
    want = np.asarray(jax_sgd.predict_margin(jnp.asarray(x), jnp.asarray(w)))
    assert np.max(np.abs(got - want)) <= 1e-5


def test_brainvision_sampling_rate_and_read_channel(tmp_path):
    import _synthetic

    from eeg_dataanalysispackage_tpu.io import brainvision as jax_bv
    from eeg_dataanalysispackage_tpu_torch.io import brainvision

    eeg = _synthetic.write_recording(str(tmp_path), n_markers=4)
    got, want = brainvision.load_recording(eeg), jax_bv.load_recording(eeg)
    assert got.header.sampling_rate_hz == want.header.sampling_rate_hz == 1000.0
    for i in range(got.header.num_channels):
        np.testing.assert_array_equal(got.read_channel(i), want.read_channel(i))
        np.testing.assert_array_equal(got.read_channel(i), got.read_channels([i])[0])


@pytest.mark.parametrize("seed", [0, 1, -7, 2**40 + 3])
def test_java_random_next_int32(seed):
    from eeg_dataanalysispackage_tpu.utils.java_compat import JavaRandom as Jax
    from eeg_dataanalysispackage_tpu_torch.utils.java_compat import JavaRandom

    got, want = JavaRandom(seed), Jax(seed)
    draws = [(got.next_int32(), got.next_int(9)) for _ in range(64)]
    assert draws == [(want.next_int32(), want.next_int(9)) for _ in range(64)]
    assert any(d < 0 for d, _ in draws) and all(-2**31 <= d < 2**31 for d, _ in draws)


def test_deadline_after():
    from eeg_dataanalysispackage_tpu.io.deadline import Deadline as Jax
    from eeg_dataanalysispackage_tpu_torch.io.deadline import Deadline

    now = [100.0]
    got, want = Deadline.after(2.5, clock=lambda: now[0]), Jax.after(2.5, clock=lambda: now[0])
    now[0] = 101.0
    assert isinstance(got, Deadline)
    assert (got.remaining(), got.expired, got.budget_s) == (want.remaining(), want.expired, 2.5)


def test_constants():
    from eeg_dataanalysispackage_tpu.utils import constants as jax_constants
    from eeg_dataanalysispackage_tpu_torch.utils import constants

    names = public_names(os.path.join(JAX, "utils", "constants.py"))
    assert {n: getattr(constants, n) for n in names} == {n: getattr(jax_constants, n) for n in names}


@pytest.mark.parametrize("wavelet,n,count", [(8, 512, 16), (2, 256, 40), (14, 750, 7)])
def test_fwt_coefficient_prefix(wavelet, n, count):
    import jax
    import jax.numpy as jnp

    from eeg_dataanalysispackage_tpu.ops import dwt as jax_dwt
    from eeg_dataanalysispackage_tpu_torch.ops import dwt, dwt_host, eegdsp_compat

    x = np.random.default_rng(wavelet).standard_normal((6, n)).astype(np.float32)
    h, g = (np.asarray(f, np.float32) for f in eegdsp_compat.filter_pair(wavelet))
    got = dwt.fwt_coefficient_prefix(torch.tensor(x), torch.tensor(h), torch.tensor(g), count)
    prefix = jax.jit(jax_dwt.fwt_coefficient_prefix, static_argnums=3)
    want = prefix(jnp.asarray(x), jnp.asarray(h), jnp.asarray(g), count)
    assert got.shape == (6, count)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-6
    host = dwt_host.dwt_coefficients(x.astype(np.float64), wavelet, count)
    assert np.max(np.abs(got.numpy() - host)) <= 1e-4


def test_bf16_feature_gate():
    from eeg_dataanalysispackage_tpu.ops import decode_ingest as jax_decode
    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest

    rng = np.random.default_rng(2)
    f32 = rng.standard_normal((64, 48)).astype(np.float32)
    rows = f32 + rng.standard_normal(f32.shape).astype(np.float32) * 1e-3
    for tol in (None, 1e-4):
        got = decode_ingest.bf16_feature_gate(torch.tensor(rows), f32, tolerance=tol)
        assert got == jax_decode.bf16_feature_gate(rows, f32, tolerance=tol)


def test_provider_feature_cache_key_and_bf16_gate_check(tmp_path):
    import _synthetic

    from eeg_dataanalysispackage_tpu.io.provider import OfflineDataProvider as Jax
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider

    info = _synthetic.write_session(str(tmp_path), n_markers=20)
    extractor = ("fused", 8, 512, 175, 16)
    provider = OfflineDataProvider([info], device="cpu")
    assert provider.feature_cache_key(extractor) == Jax([info]).feature_cache_key(extractor)
    recordings = provider.prepare_fused_run(extractor).recordings
    got = provider.bf16_gate_check(recordings, max_rows=16)
    want = provider.precision_gate_check(recordings, precision="bf16", max_rows=16)
    drop = ("gate_seconds", "cached")
    assert {k: v for k, v in got.items() if k not in drop} == \
        {k: v for k, v in want.items() if k not in drop}
    assert got["precision"] == "bf16" and 0 < got["rows_checked"] <= 16 and got["ok"]
