"""Remote locations are refused before anything is opened.

The JAX package opens a location with a URI scheme (``https://``,
``gs://``, ``hdfs://``) on a remote filesystem. The port does not read
remote filesystems yet: every such location (``info_file=``, a ``.eeg``
argument, ``load_name=``, ``save_name=``, ``result_path=``, a served or
tenant model) raises "not yet ported; see ROADMAP.md" before any file
or socket is opened. The locations point at an unroutable local port,
and a spy on ``socket`` records every connection attempt.
"""

import os
import socket
import sys

import pytest

from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.serve import InferenceService
from eeg_dataanalysispackage_tpu_torch.serve import pipeline as serve_pipeline

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    return {"info": info, "model": model}


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
    PipelineBuilder(query, device="cpu").execute()


CASES = {
    "info_file": lambda l: _run(f"info_file={URL}/info.txt&fe=dwt-8-fused&train_clf=logreg"),
    "eeg_file": lambda l: _run(f"eeg_file={URL}/rec.eeg&guessed_num=2&fe=dwt-8&train_clf=logreg"),
    "provider_gs": lambda l: OfflineDataProvider(["gs://bucket/info.txt"], device="cpu").load(),
    "provider_hdfs_eeg": lambda l: OfflineDataProvider(
        ["hdfs://namenode:8020/rec.eeg", "2"], device="cpu").load_features_device(),
    "load_name": lambda l: _run(f"info_file={l['info']}&fe=dwt-8-fused&load_clf=logreg"
                                f"&load_name={URL}/model"),
    "save_name": lambda l: _run(f"info_file={l['info']}&fe=dwt-8-fused&train_clf=logreg"
                                f"&save_clf=true&save_name=hdfs://namenode:8020/model"),
    "result_path": lambda l: _run(f"info_file={l['info']}&fe=dwt-8-fused&load_clf=logreg"
                                  f"&load_name={l['model']}&result_path={URL}/result.txt"),
    "serve_load_name": lambda l: _run(f"info_file={l['info']}&fe=dwt-8-fused&serve=true"
                                      f"&load_clf=logreg&load_name={URL}/model"),
    "service_from_saved": lambda l: InferenceService.from_saved(
        "logreg", f"{URL}/model", device="cpu"),
    "tenant_spec": lambda l: serve_pipeline.load_tenants(f"alice=logreg@{URL}/model"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_remote_location_raises_before_opening(local, connections, case):
    with pytest.raises(ValueError, match=r"remote locations \([a-z]+://\) are not yet "
                                         r"ported; see ROADMAP.md"):
        CASES[case](local)
    assert connections == []


def test_local_paths_still_run(local, connections):
    _run(f"info_file={local['info']}&fe=dwt-8-fused&load_clf=logreg&load_name={local['model']}")
    assert connections == []
