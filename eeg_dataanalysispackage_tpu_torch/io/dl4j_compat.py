"""DL4J model-zip ARCHITECTURE import (the open half of the NN format).

Port of the JAX package's ``io/dl4j_compat.py``, pure Python; the
archive or JSON file is read through ``io/modelfiles``, so local paths
and remote URIs (``http(s)://``, ``gs://``, ``hdfs://``) import alike.

The reference saves its neural nets with DL4J's ``ModelSerializer``
(NeuralNetworkClassifier.java:171-176): a zip whose
``coefficients.bin`` wraps ND4J's closed native array serialization
(weights NOT importable — documented out of scope,
io/mllib_format.py docstring) but whose ``configuration.json`` is
plain Jackson JSON of the ``MultiLayerConfiguration`` the classifier
built from its ``config_*`` keys (NeuralNetworkClassifier.java:
96-130, 258-320). This module inverts that mapping: it reads the
JSON (from the zip or a bare file) and reconstructs the ``config_*``
dictionary, so a reference deployment's NN *architecture* ports in
one call and retrains on this framework::

    cfg = import_dl4j_architecture("model.zip")
    clf = registry.create("nn"); clf.set_config(cfg); clf.fit(X, y)

Parsing is deliberately tolerant across DL4J 0.x serialization
variants (the reference pins 0.8.0, pom.xml:105-108, but field
encodings shifted between 0.x releases): layer type from the
one-key wrapper object (``{"dense": {...}}``) or an ``@class`` tag;
activation from an ``activationFn`` ``@class`` (0.7+) or a bare
``activationFunction`` string (pre-0.7); enum-ish values normalized
case-insensitively. Anything that does not look like a
MultiLayerConfiguration raises with a pointer to what was found.
"""

from __future__ import annotations

import io
import json
import re
import zipfile
from typing import Dict, Optional

from . import modelfiles

#: JSON spellings -> the reference's config_layer*_layer_type values
#: (NeuralNetworkClassifier.java:269-312)
_LAYER_TYPES = {
    "output": "output",
    "outputlayer": "output",
    "dense": "dense",
    "denselayer": "dense",
    "autoencoder": "auto_encoder",
    "rbm": "rbm",
    "graveslstm": "graves_lstm",
}

_ACTIVATIONS = {
    "sigmoid": "sigmoid",
    "softmax": "softmax",
    "relu": "relu",
    "tanh": "tanh",
    "identity": "identity",
    "softplus": "softplus",
    "elu": "elu",
}

_LOSSES = {
    "mse": "mse",
    "mcxent": "xent",
    "xent": "xent",
    "binaryxent": "xent",
    "squaredloss": "squared_loss",
    "l2": "squared_loss",
    "negativeloglikelihood": "negativeloglikelihood",
}

_UPDATERS = {
    "sgd": "sgd",
    "adam": "adam",
    "nesterovs": "nesterovs",
    "adagrad": "adagrad",
    "rmsprop": "rmsprop",
}

_OPT_ALGOS = {
    "stochasticgradientdescent": "stochastic_gradient_descent",
    "linegradientdescent": "line_gradient_descent",
    "conjugategradient": "conjugate_gradient",
    "lbfgs": "lbfgs",
}

_WEIGHT_INITS = {
    "xavier": "xavier",
    "zero": "zero",
    "sigmoid": "sigmoid",
    "sigmoiduniform": "sigmoid",
    "uniform": "uniform",
    "relu": "relu",
}


def _squash(name: str) -> str:
    """'ActivationReLU' / 'GRAVES_LSTM' / 'relu' -> comparable key."""
    return re.sub(r"[^a-z0-9]", "", name.lower())


def _enum(value, table: Dict[str, str], kind: str) -> Optional[str]:
    """Normalize a JSON enum-ish value through a spelling table.
    Accepts raw strings, ``{"@class": "...impl.ActivationSigmoid"}``
    wrappers, and DL4J class-name prefixes (``Activation``/``Loss``/
    ``WeightInit``)."""
    if value is None:
        return None
    if isinstance(value, dict):
        value = value.get("@class", "")
        value = value.rsplit(".", 1)[-1]
    s = _squash(str(value))
    for prefix in ("activation", "loss", "weightinit", "updater"):
        if s.startswith(prefix) and s[len(prefix):] in table:
            s = s[len(prefix):]
            break
    if s in table:
        return table[s]
    raise ValueError(f"unrecognized DL4J {kind}: {value!r}")


def read_configuration_json(path: str) -> dict:
    """The ``configuration.json`` document from a ModelSerializer zip
    (any entry name containing 'configuration'), or from a bare JSON
    file, at a local path or a remote URI."""
    raw = modelfiles.read_model_bytes(path)
    if zipfile.is_zipfile(io.BytesIO(raw)):
        with zipfile.ZipFile(io.BytesIO(raw)) as z:
            names = [
                n for n in z.namelist() if "configuration" in n.lower()
            ]
            if not names:
                raise ValueError(
                    f"{path} is a zip without a configuration.json "
                    f"entry (found: {z.namelist()[:6]}) — not a DL4J "
                    f"ModelSerializer archive"
                )
            return json.loads(z.read(names[0]).decode("utf-8"))
    return json.loads(raw.decode("utf-8"))


def _layer_of(conf: dict) -> tuple:
    """(layer_type, layer_fields) from one entry of ``confs``.

    0.x encodings: ``conf["layer"]`` is either a one-key wrapper
    ``{"dense": {...}}`` or a flat dict with an ``@class`` tag."""
    layer = conf.get("layer")
    if not isinstance(layer, dict) or not layer:
        raise ValueError(
            f"conf entry has no layer object (keys: {sorted(conf)})"
        )
    if "@class" in layer:
        cls = layer["@class"].rsplit(".", 1)[-1]
        key = _squash(cls)
        fields = layer
    elif len(layer) == 1:
        (key, fields), = layer.items()
        key = _squash(key)
        if not isinstance(fields, dict):
            raise ValueError(f"layer wrapper {key!r} holds no fields")
    else:
        # some 0.x builds inline the fields next to a "type" tag
        key = _squash(str(layer.get("type", "")))
        fields = layer
    if key not in _LAYER_TYPES:
        raise ValueError(
            f"unrecognized DL4J layer type {key!r} (supported: "
            f"{sorted(set(_LAYER_TYPES.values()))})"
        )
    return _LAYER_TYPES[key], fields


def _field(fields: dict, *names, default=None):
    for n in names:
        if n in fields and fields[n] is not None:
            return fields[n]
    return default


def import_dl4j_architecture(path: str) -> Dict[str, str]:
    """DL4J zip / configuration.json -> the reference's ``config_*``
    dictionary (NeuralNetworkClassifier's full key surface), ready
    for ``NeuralNetworkClassifier.set_config``. Weights are NOT
    imported (closed ND4J serialization) — retrain after porting."""
    doc = read_configuration_json(path)
    confs = doc.get("confs")
    if not isinstance(confs, list) or not confs:
        raise ValueError(
            f"not a MultiLayerConfiguration: no 'confs' list "
            f"(top-level keys: {sorted(doc)[:8]})"
        )

    cfg: Dict[str, str] = {}
    first = confs[0]
    # globals live on the per-layer NeuralNetConfiguration clones;
    # the first conf is authoritative (the builder applied them
    # uniformly — NeuralNetworkClassifier.java:96-120)
    seed = _field(first, "seed")
    if seed is not None:
        cfg["config_seed"] = str(int(seed))
    iters = _field(first, "numIterations", "iterationCount", "iterations")
    if iters is not None:
        cfg["config_num_iterations"] = str(int(iters))
    algo = _field(first, "optimizationAlgo", "optimizationAlgorithm")
    if algo is not None:
        cfg["config_optimization_algo"] = _enum(
            algo, _OPT_ALGOS, "optimization algo"
        )
    for flag in ("pretrain", "backprop"):
        if isinstance(doc.get(flag), bool):
            cfg[f"config_{flag}"] = "true" if doc[flag] else "false"

    loss = None
    for i, conf in enumerate(confs, start=1):
        ltype, fields = _layer_of(conf)
        cfg[f"config_layer{i}_layer_type"] = ltype
        n_out = _field(fields, "nout", "nOut")
        if n_out is None:
            raise ValueError(f"layer {i} ({ltype}) has no nOut")
        cfg[f"config_layer{i}_n_out"] = str(int(n_out))
        cfg[f"config_layer{i}_drop_out"] = str(
            float(_field(fields, "dropOut", "dropout", default=0.0))
        )
        act = _field(fields, "activationFn", "activationFunction",
                     "activation")
        cfg[f"config_layer{i}_activation_function"] = (
            _enum(act, _ACTIVATIONS, "activation")
            if act is not None
            else "sigmoid"
        )
        lf = _field(fields, "lossFn", "lossFunction", "loss")
        if lf is not None:
            loss = _enum(lf, _LOSSES, "loss")
        # training globals: 0.7+ clones them onto each LAYER; pre-0.7
        # keeps them on the conf object — read both homes (layer
        # first), first occurrence wins
        upd = _field(fields, "updater") or _field(conf, "updater")
        if upd is not None and "config_updater" not in cfg:
            cfg["config_updater"] = _enum(upd, _UPDATERS, "updater")
        lr = _field(fields, "learningRate")
        if lr is None:
            lr = _field(conf, "learningRate")
        if lr is not None and "config_learning_rate" not in cfg:
            cfg["config_learning_rate"] = str(float(lr))
        mom = _field(fields, "momentum")
        if mom is None:
            mom = _field(conf, "momentum")
        if mom is not None and "config_momentum" not in cfg:
            cfg["config_momentum"] = str(float(mom))
        wi = _field(fields, "weightInit") or _field(conf, "weightInit")
        if wi is not None and "config_weight_init" not in cfg:
            cfg["config_weight_init"] = _enum(
                wi, _WEIGHT_INITS, "weight init"
            )
    if loss is not None:
        cfg["config_loss_function"] = loss
    return cfg
