"""The port's DL4J architecture import against the JAX package's.

``io/dl4j_compat.import_dl4j_architecture`` of both packages on the JAX
tests' fixtures (0.8 one-key layer wrappers, pre-0.7 class-tagged layers
with string activations, zips, bare JSON) gives the same ``config_*``
map or the same error; the port also reads from a loopback ``http://``
store, and an imported architecture trains in both packages alike.
"""

import json
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.io import dl4j_compat as jax_dc
from eeg_dataanalysispackage_tpu.models import nn as jax_nn
from eeg_dataanalysispackage_tpu_torch.io import dl4j_compat as dc
from eeg_dataanalysispackage_tpu_torch.models import nn

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _loopback  # noqa: E402
from test_dl4j_compat import _conf_v08  # noqa: E402

PRE07 = {
    "backprop": True,
    "pretrain": True,
    "confs": [
        {"seed": 11, "iterations": 5, "learningRate": 0.05, "momentum": 0.4,
         "updater": "SGD", "weightInit": "RELU", "optimizationAlgorithm": "LBFGS",
         "layer": {"@class": "org.deeplearning4j.nn.conf.layers.AutoEncoder",
                   "nOut": 16, "dropout": 0.3, "activationFunction": "sigmoid"}},
        {"layer": {"@class": "org.deeplearning4j.nn.conf.layers.OutputLayer",
                   "nOut": 2, "activationFunction": "softmax",
                   "lossFunction": "NEGATIVELOGLIKELIHOOD"}},
    ],
}

TYPE_TAGGED = {
    "confs": [
        {"numIterations": 3, "layer": {"type": "GravesLSTM", "nOut": 4,
                                       "activation": "TANH", "updater": "RMSPROP"}},
        {"layer": {"type": "OutputLayer", "nOut": 2, "activation": {"@class": "x.ActivationSoftmax"},
                   "loss": "L2", "weightInit": "SIGMOID_UNIFORM"}},
    ],
}

DOCS = {
    "v08": _conf_v08(),
    "v08-three-layers": _conf_v08(3),
    "pre07": PRE07,
    "type-tagged": TYPE_TAGGED,
    "no-confs": {"weights": [1, 2, 3]},
    "bad-layer": {"confs": [{"layer": {"conv2d": {}}}]},
    "no-layer": {"confs": [{"seed": 1}]},
    "no-nout": {"confs": [{"layer": {"dense": {"dropOut": 0.1}}}]},
    "bad-activation": {"confs": [{"layer": {"dense": {"nOut": 3, "activationFn": "swish"}}}]},
}


def _both(path):
    try:
        want = jax_dc.import_dl4j_architecture(path)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            dc.import_dl4j_architecture(path)
        assert str(mine.value) == str(e)
        return None
    got = dc.import_dl4j_architecture(path)
    assert list(got.items()) == list(want.items())
    return got


@pytest.mark.parametrize("name", list(DOCS))
@pytest.mark.parametrize("container", ["json", "zip"])
def test_import_equals_jax(name, container, tmp_path):
    doc = json.dumps(DOCS[name])
    if container == "json":
        path = tmp_path / "configuration.json"
        path.write_text(doc)
    else:
        path = tmp_path / "model.zip"
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("configuration.json", doc)
            zf.writestr("coefficients.bin", b"\x00" * 64)  # opaque ND4J bytes
    _both(str(path))


def test_zip_without_configuration_and_enum_errors_match(tmp_path):
    z = tmp_path / "other.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("something.bin", b"x")
    with pytest.raises(ValueError) as want:
        jax_dc.read_configuration_json(str(z))
    with pytest.raises(ValueError) as got:
        dc.read_configuration_json(str(z))
    assert str(got.value) == str(want.value)
    for table in ("_ACTIVATIONS", "_LOSSES", "_UPDATERS", "_OPT_ALGOS", "_WEIGHT_INITS",
                  "_LAYER_TYPES"):
        assert getattr(dc, table) == getattr(jax_dc, table)
    with pytest.raises(ValueError, match="activation"):
        dc._enum("ActivationSwish", dc._ACTIVATIONS, "activation")


def test_remote_archive_imports_like_the_local_one(tmp_path):
    z = tmp_path / "model.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("conf/configuration.json", json.dumps(_conf_v08()))
    want = jax_dc.import_dl4j_architecture(str(z))
    with _loopback.Server() as srv:
        srv.store.add_tree(str(tmp_path), "/models")
        got = dc.import_dl4j_architecture(f"http://{srv.authority}/models/model.zip")
    assert got == want


def test_imported_architecture_trains_like_the_jax_package(tmp_path):
    p = tmp_path / "configuration.json"
    p.write_text(json.dumps(_conf_v08()))
    cfg = dc.import_dl4j_architecture(str(p))
    cfg["config_num_iterations"] = "15"
    cfg["config_pretrain"] = "false"
    rng = np.random.RandomState(0)
    x = rng.randn(48, 10).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float64)
    theirs = jax_nn.NeuralNetworkClassifier()
    theirs.set_config(cfg)
    theirs.fit(x, y)
    ours = nn.NeuralNetworkClassifier()
    ours.set_config(cfg)
    ours.fit(torch.from_numpy(x), torch.from_numpy(y).float())
    np.testing.assert_allclose(ours.predict(torch.from_numpy(x)).numpy(), theirs.predict(x),
                               rtol=0, atol=1e-5)
