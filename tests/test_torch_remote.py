"""Remote locations through the port's entry points.

Every location the JAX package routes by URI scheme — ``info_file=``,
``eeg_file=``, the ``OfflineDataProvider`` arguments, ``save_name=``,
``load_name=`` (batch and ``serve=true``),
``InferenceService.from_saved``, ``MultiplexedService.from_saved`` and a
tenant spec — runs against the
loopback object store and WebHDFS namenode (``tests/_loopback.py``) and
gives what the same call gives on local paths. A spy on ``socket``
records every connection: each one goes to the loopback server.
``result_path=`` stays a local file, as the JAX package writes it: a
``scheme://`` ``result_path`` raises before anything is opened.
"""

import os
import socket
import sys

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu_torch.io import circuit, remote
from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.serve import InferenceService, MultiplexedService
from eeg_dataanalysispackage_tpu_torch.serve import pipeline as serve_pipeline

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _loopback  # noqa: E402
import _synthetic  # noqa: E402

URL = "https://127.0.0.1:1"


@pytest.fixture(scope="module")
def local(tmp_path_factory):
    """A local one-file session and a model the port trained on it."""
    tmp = tmp_path_factory.mktemp("torch_remote")
    info = _synthetic.write_session(str(tmp), n_markers=40)
    model = str(tmp / "model")
    PipelineBuilder(f"info_file={info}&fe=dwt-8-fused&train_clf=logreg"
                    f"&save_clf=true&save_name={model}", device="cpu").execute()
    return {"info": info, "dir": str(tmp), "model": model,
            "eeg": os.path.join(str(tmp), "synth_01.eeg")}


@pytest.fixture(scope="module")
def loopback(local):
    """The session under /data and the model at /models/model.npz, on
    both faces of one server (http://<authority>/... and
    hdfs://<authority>/...)."""
    with _loopback.Server() as srv:
        srv.store.add_tree(local["dir"], "/data")
        srv.store.files["/models/model.npz"] = srv.store.files.pop("/data/model.npz")
        yield srv


@pytest.fixture
def connections(monkeypatch):
    """Every socket connection attempted while the test runs."""
    seen = []

    def spy(name):
        real = getattr(socket.socket, name)

        def connect(self, address):
            seen.append(address)
            return real(self, address)
        return connect

    for name in ("connect", "connect_ex"):
        monkeypatch.setattr(socket.socket, name, spy(name))
    return seen


def _run(query):
    return str(PipelineBuilder(query, device="cpu").execute())


def _margins(classifier):
    rows = np.random.RandomState(3).randn(16, 48).astype(np.float32)
    return classifier.margin(torch.from_numpy(rows)).numpy()


def _local_classifier(local):
    from eeg_dataanalysispackage_tpu_torch.models import linear

    clf = linear.LogisticRegressionClassifier()
    clf.load(local["model"])
    return clf


FUSED = "fe=dwt-8-fused&train_clf=logreg"


def _save_name(l, s):
    """Train and save to hdfs://; the stored bytes load to the local model's statistics."""
    got = _run(f"info_file={l['info']}&{FUSED}&save_clf=true&save_name=hdfs://{s.authority}/m2")
    assert "/m2.npz" in s.store.files
    return got, _run(f"info_file={l['info']}&{FUSED}")


def _service_from_saved(l, s):
    with InferenceService.from_saved("logreg", f"{s.base}/models/model", device="cpu") as svc:
        got = _margins(svc.engine.classifier)
    return got.tobytes(), _margins(_local_classifier(l)).tobytes()


def _tenant_spec(l, s):
    tenants = serve_pipeline.load_tenants(
        f"alice=logreg@{s.base}/models/model,bob=logreg@hdfs://{s.authority}/models/model")
    assert sorted(tenants) == ["alice", "bob"]
    want = _margins(_local_classifier(l)).tobytes()
    return [_margins(t).tobytes() for t in tenants.values()], [want, want]


def _multiplexed_from_saved(l, s):
    tenants = {"alice": ("logreg", f"{s.base}/models/model"),
               "bob": ("logreg", f"hdfs://{s.authority}/models/model")}
    with MultiplexedService.from_saved(tenants, device="cpu") as svc:
        assert svc.tenants == ("alice", "bob")
        engine = svc.engine
        got = [_margins(engine._classifiers[engine._lanes[t]]).tobytes() for t in svc.tenants]
    want = _margins(_local_classifier(l)).tobytes()
    return got, [want, want]


def _provider_gs(l, s):
    fs = remote.GcsFileSystem(endpoint=s.base)
    got = OfflineDataProvider(["gs://data/info.txt"], filesystem=fs, device="cpu").load()
    want = OfflineDataProvider([l["info"]], device="cpu").load()
    return got.epochs.tobytes(), want.epochs.tobytes()


def _provider_hdfs_eeg(l, s):
    got, _ = OfflineDataProvider([f"hdfs://{s.authority}/data/synth_01.eeg", "2"],
                                 device="cpu").load_features_device()
    want, _ = OfflineDataProvider([l["eeg"], "2"], device="cpu").load_features_device()
    return got.numpy().tobytes(), want.numpy().tobytes()


#: each call of the refusal cases this file pinned before remote
#: filesystems were ported, run against the loopback server: (what it
#: gives over the server, what it gives on local paths)
CASES = {
    "info_file": lambda l, s: (_run(f"info_file={s.base}/data/info.txt&{FUSED}"),
                               _run(f"info_file={l['info']}&{FUSED}")),
    "eeg_file": lambda l, s: (
        _run(f"eeg_file={s.base}/data/synth_01.eeg&guessed_num=2&fe=dwt-8&train_clf=logreg"),
        _run(f"eeg_file={l['eeg']}&guessed_num=2&fe=dwt-8&train_clf=logreg")),
    "provider_gs": _provider_gs,
    "provider_hdfs_eeg": _provider_hdfs_eeg,
    "load_name": lambda l, s: (
        _run(f"info_file={l['info']}&fe=dwt-8-fused&load_clf=logreg"
             f"&load_name={s.base}/models/model"),
        _run(f"info_file={l['info']}&fe=dwt-8-fused&load_clf=logreg&load_name={l['model']}")),
    "save_name": _save_name,
    "serve_load_name": lambda l, s: (
        _run(f"info_file=hdfs://{s.authority}/data/info.txt&fe=dwt-8-fused&serve=true"
             f"&load_clf=logreg&load_name=hdfs://{s.authority}/models/model"),
        _run(f"info_file={l['info']}&fe=dwt-8-fused&load_clf=logreg&load_name={l['model']}")),
    "service_from_saved": _service_from_saved,
    "multiplexed_from_saved": _multiplexed_from_saved,
    "tenant_spec": _tenant_spec,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_remote_location_runs_as_local(local, loopback, connections, case):
    circuit.reset()
    got, want = CASES[case](local, loopback)
    assert got == want
    assert connections and all(a[:2] == ("127.0.0.1", int(loopback.authority.split(":")[1]))
                               for a in connections)


@pytest.mark.parametrize("case", ["result_path"])
def test_remote_location_raises_before_opening(local, connections, case):
    with pytest.raises(ValueError, match=r"result_path='https://127.0.0.1:1/result.txt': "
                                         r"remote locations \(https://\) are not supported"):
        _run(f"info_file={local['info']}&fe=dwt-8-fused&load_clf=logreg"
             f"&load_name={local['model']}&result_path={URL}/result.txt")
    assert connections == []
    assert not os.path.exists("https:")


def test_local_paths_still_run(local, connections):
    _run(f"info_file={local['info']}&fe=dwt-8-fused&load_clf=logreg&load_name={local['model']}")
    assert connections == []
