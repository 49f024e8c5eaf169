"""The port's WebHDFS filesystem and ``hdfs://`` runs against the JAX package.

Twin of ``tests/test_webhdfs.py`` for ``eeg_dataanalysispackage_tpu_torch``.
A mock namenode and datanode (one ``http.server`` playing both roles,
``tests/_loopback.py``: the namenode 307-redirects OPEN and CREATE to
datanode URLs, as the WebHDFS REST contract says) drive the whole client:
GETFILESTATUS-driven chunked OPEN reads with offset/length, the CREATE
two-step write, HttpFS-style gateways without redirects, relative
``Location`` headers, retries, ``WEBHDFS_ENDPOINT``/``WEBHDFS_USER``,
and the provider and pipeline end to end with ``info_file=hdfs://...``
(the reference's own flow, Const.java:38-39 + OffLineDataProvider.java:90):
``str(statistics)`` equal, byte for byte, to the port's local run and the
JAX package's run over the same namenode.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu.io import remote as jax_remote
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch.io import brainvision, circuit, export, provider, remote
from eeg_dataanalysispackage_tpu_torch.models.linear import LogisticRegressionClassifier
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.serve import InferenceService

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _loopback  # noqa: E402


@pytest.fixture(scope="module")
def loopback():
    with _loopback.Server() as srv:
        yield srv


@pytest.fixture()
def namenode(loopback, monkeypatch):
    monkeypatch.delenv("WEBHDFS_ENDPOINT", raising=False)
    monkeypatch.delenv("WEBHDFS_USER", raising=False)
    monkeypatch.delenv("HDFS_DRIVER", raising=False)
    # the JAX package's parse pool shares one (not thread-safe) remote
    # filesystem between its workers: its runs parse one file at a time
    monkeypatch.setenv("EEG_TPU_INGEST_WORKERS", "1")
    store = loopback.reset()
    circuit.reset()
    jax_remote.circuit.reset()
    yield loopback.authority, store
    circuit.reset()
    jax_remote.circuit.reset()


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _loopback.write_remote_session(str(tmp_path_factory.mktemp("hdfs_session")))


def _fs(**kw):
    kw.setdefault("retry", remote.RetryPolicy(max_attempts=4, timeout_s=5.0, backoff_s=0.01))
    return remote.WebHdfsFileSystem(**kw)


def test_exists_read_write_roundtrip(namenode):
    auth, store = namenode
    fs = _fs()
    uri = f"hdfs://{auth}/data/a.bin"
    assert not fs.exists(uri)
    fs.write_bytes(uri, b"on the cluster")
    assert store.files["/data/a.bin"] == b"on the cluster"
    assert fs.exists(uri)
    assert fs.read_bytes(uri) == b"on the cluster"
    assert fs.read_text(uri) == "on the cluster"


def test_redirect_hops_to_datanode(namenode):
    auth, store = namenode
    fs = _fs()
    fs.write_bytes(f"hdfs://{auth}/x", b"z" * 10)
    assert fs.read_bytes(f"hdfs://{auth}/x") == b"z" * 10
    dn_puts = [p for m, p in store.requests if m == "PUT" and p.startswith("/dn")]
    dn_gets = [p for m, p in store.requests if m == "GET" and p.startswith("/dn")]
    assert dn_puts and dn_gets  # the data flowed through the datanode role


def test_chunked_open_reads_use_offset_length(namenode):
    auth, store = namenode
    payload = bytes(range(256)) * 100  # 25600 B
    store.files["/big.bin"] = payload
    assert _fs(chunk_size=10_000).read_bytes(f"hdfs://{auth}/big.bin") == payload
    opens = [p for m, p in store.requests
             if m == "GET" and "op=OPEN" in p and not p.startswith("/dn")]
    assert len(opens) == 3  # ceil(25600/10000) namenode OPENs
    assert "offset=10000" in opens[1] and "offset=20000" in opens[2]


def test_read_range(namenode):
    auth, store = namenode
    store.files["/blk"] = bytes(range(200))
    assert _fs().read_range(f"hdfs://{auth}/blk", 20, 7) == bytes(range(20, 27))


def test_missing_file_raises_filenotfound(namenode):
    auth, _ = namenode
    with pytest.raises(FileNotFoundError):
        _fs().read_bytes(f"hdfs://{auth}/nope")


def test_transient_500s_retried(namenode):
    auth, store = namenode
    store.files["/flaky"] = b"q" * 50
    store.fail_next = 2
    assert _fs().read_bytes(f"hdfs://{auth}/flaky") == b"q" * 50


def test_truncated_open_body_is_retried(namenode):
    auth, store = namenode
    payload = np.random.RandomState(1).bytes(30_000)
    store.files["/cut"] = payload
    store.truncate_next = 2
    assert _fs(chunk_size=8_000).read_bytes(f"hdfs://{auth}/cut") == payload


def test_retry_budget_exhausts_loudly(namenode):
    auth, store = namenode
    store.files["/dead"] = b"x"
    store.fail_next = 99
    with pytest.raises(remote.RemoteIOError, match="after 4 attempts"):
        _fs().read_bytes(f"hdfs://{auth}/dead")


def test_httpfs_gateway_without_redirects(namenode):
    auth, store = namenode
    store.no_redirect = True
    fs = _fs()
    uri = f"hdfs://{auth}/gw.bin"
    fs.write_bytes(uri, b"direct body")
    assert store.files["/gw.bin"] == b"direct body"
    assert fs.read_bytes(uri) == b"direct body"


def test_endpoint_override_maps_rpc_authority(namenode):
    auth, store = namenode
    store.files["/data/x"] = b"mapped"
    assert _fs(endpoint=f"http://{auth}").read_bytes("hdfs://localhost:8020/data/x") == b"mapped"


def test_default_fs_uri_without_endpoint_fails_fast(namenode):
    auth, store = namenode
    with pytest.raises(ValueError, match="no authority"):
        _fs().read_bytes("hdfs:///data/x")
    store.files["/data/x"] = b"df"
    assert _fs(endpoint=f"http://{auth}").read_bytes("hdfs:///data/x") == b"df"


def test_endpoint_env_var_reaches_scheme_routed_instances(namenode, monkeypatch):
    auth, store = namenode
    store.files["/data/env"] = b"via env"
    monkeypatch.setenv("WEBHDFS_ENDPOINT", f"http://{auth}")
    monkeypatch.setenv("WEBHDFS_USER", "envuser")
    fs = remote.filesystem_for("hdfs://namenode.invalid:8020/data/env")
    fs.retry = remote.RetryPolicy(max_attempts=2, timeout_s=5.0, backoff_s=0.01)
    assert fs.read_bytes("hdfs://namenode.invalid:8020/data/env") == b"via env"
    assert any("user.name=envuser" in p for _, p in store.requests)


class _RelativeRedirect(_loopback.Handler):
    """A proxy answering OPEN with a relative ``Location``."""

    def _redirect(self):
        self._send(307, headers=[("Location", f"/dn{self.path}")])


def test_relative_location_header_resolved():
    with _loopback.Server(_RelativeRedirect) as srv:
        srv.store.files["/rel"] = b"relative ok"
        assert _fs().read_bytes(f"hdfs://{srv.authority}/rel") == b"relative ok"
        _fs().write_bytes(f"hdfs://{srv.authority}/rel2", b"relative put")
        assert srv.store.files["/rel2"] == b"relative put"


def test_user_name_param(namenode):
    auth, store = namenode
    store.files["/u"] = b"1"
    _fs(user="eegupdate").read_bytes(f"hdfs://{auth}/u")
    assert any("user.name=eegupdate" in p for _, p in store.requests)


class _Portal(_loopback.Handler):
    def do_GET(self):
        self._send(200, b"<html>welcome to the portal</html>")


class _DirectoryStatus(_loopback.Handler):
    def do_GET(self):
        self._send(200, json.dumps({"FileStatus": {"length": 0, "type": "DIRECTORY"}}).encode())


def test_non_webhdfs_responder_stays_in_ioerror_contract():
    with _loopback.Server(_Portal) as srv:
        with pytest.raises(remote.RemoteIOError, match="unparseable"):
            _fs().exists(f"hdfs://{srv.authority}/anything")
        with pytest.raises(remote.RemoteIOError, match="unparseable"):
            _fs().list_dir(f"hdfs://{srv.authority}/anything")


def test_directory_read_raises_isadirectory():
    with _loopback.Server(_DirectoryStatus) as srv:
        with pytest.raises(IsADirectoryError):
            _fs().read_bytes(f"hdfs://{srv.authority}/models/")


def test_list_dir_and_delete_dir(namenode):
    auth, store = namenode
    store.files.update({"/m/metadata/part-00000": b"x", "/m/data/part-r-0": b"y", "/n": b"z"})
    fs = _fs()
    assert fs.list_dir(f"hdfs://{auth}/m") == ["data", "metadata"]
    with pytest.raises(FileNotFoundError):
        fs.list_dir(f"hdfs://{auth}/nope")
    fs.delete_dir(f"hdfs://{auth}/m")
    fs.delete_dir(f"hdfs://{auth}/m")  # a missing target is fine
    assert list(store.files) == ["/n"]


def test_filesystem_for_routes_hdfs():
    assert isinstance(remote.filesystem_for("hdfs://localhost:8020/x"), remote.WebHdfsFileSystem)


# -- end to end over a served session --------------------------------------


def _serve_session(store, session):
    store.add_tree(os.path.dirname(session), "/data")


def test_provider_over_hdfs_matches_local_and_jax_package(namenode, session):
    auth, store = namenode
    _serve_session(store, session)
    uri = f"hdfs://{auth}/data/infoTrain.txt"
    got = provider.OfflineDataProvider([uri], filesystem=_fs(chunk_size=1 << 18),
                                       device="cpu").load()
    local = provider.OfflineDataProvider([session], device="cpu").load()
    jax_batch = jax_provider.OfflineDataProvider([uri]).load()
    np.testing.assert_array_equal(got.epochs, local.epochs)
    np.testing.assert_array_equal(got.targets, local.targets)
    np.testing.assert_array_equal(got.epochs, np.asarray(jax_batch.epochs))
    feats, _ = provider.OfflineDataProvider([uri], device="cpu").load_features_device()
    want, _ = provider.OfflineDataProvider([session], device="cpu").load_features_device()
    assert feats.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("fe", ["dwt-8", "dwt-8-fused"])
def test_pipeline_over_hdfs_equals_local_and_jax_package(namenode, session, fe):
    auth, store = namenode
    _serve_session(store, session)
    q = f"fe={fe}&train_clf=logreg"
    got = PipelineBuilder(f"info_file=hdfs://{auth}/data/infoTrain.txt&{q}",
                          device="cpu").execute()
    assert str(got) == str(PipelineBuilder(f"info_file={session}&{q}", device="cpu").execute())
    assert str(got) == str(JaxBuilder(f"info_file=hdfs://{auth}/data/infoTrain.txt&{q}").execute())


def test_model_save_load_over_hdfs(namenode):
    auth, store = namenode
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(40, 48).astype(np.float32))
    clf = LogisticRegressionClassifier()
    clf.set_config({})
    clf.fit(feats, (feats[:, 0] > 0).float())
    clf.save(f"hdfs://{auth}/models/logreg")
    assert "/models/logreg.npz" in store.files
    clf2 = LogisticRegressionClassifier()
    clf2.load(f"hdfs://{auth}/models/logreg")
    np.testing.assert_array_equal(clf2.model.weight.numpy(), clf.model.weight.numpy())


def test_pipeline_save_load_model_over_hdfs(namenode, session):
    """save_clf/load_clf with hdfs:// save_name and load_name through the
    query DSL — the reference's models-on-HDFS flow
    (LogisticRegressionClassifier.java:144-152): the port's statistics
    equal the JAX package's on the same namenode, on both sides of the
    save (train, then load), and the served model equals the batch run."""
    auth, store = namenode
    _serve_session(store, session)
    model = f"hdfs://{auth}/models/pipeline-logreg"
    info = f"info_file=hdfs://{auth}/data/infoTrain.txt&fe=dwt-8-fused"
    train = f"{info}&train_clf=logreg&save_clf=true&save_name={model}"
    trained = PipelineBuilder(train, device="cpu").execute()
    port_bytes = store.files["/models/pipeline-logreg.npz"]
    assert str(trained) == str(JaxBuilder(train).execute())
    load = f"{info}&load_clf=logreg&load_name={model}"
    jax_loaded = JaxBuilder(load).execute()  # the JAX package's own model
    store.files["/models/pipeline-logreg.npz"] = port_bytes
    loaded = PipelineBuilder(load, device="cpu").execute()
    assert str(loaded) == str(jax_loaded)
    served = PipelineBuilder(load.replace("&load_clf", "&serve=true&load_clf"),
                             device="cpu").execute()
    assert str(served) == str(loaded)
    with InferenceService.from_saved("logreg", model, device="cpu") as service:
        assert service.engine.mode  # built around the hdfs:// model


def test_raw_channel_text_export_over_hdfs(namenode, session):
    """The reference's HadoopLoadingTest.tryRAWEEG flow over WebHDFS: read
    a channel from hdfs://, write it back as saveAsTextFile-format text
    (Double.toString lines) to hdfs://; the stored bytes equal the JAX
    package's for the same channel."""
    from eeg_dataanalysispackage_tpu.io import brainvision as jax_bv
    from eeg_dataanalysispackage_tpu.io import export as jax_export

    auth, store = namenode
    _serve_session(store, session)
    rec = brainvision.load_recording(f"hdfs://{auth}/data/DoD/synth_01.eeg",
                                     filesystem=_fs(chunk_size=1 << 20))
    channel = rec.read_channels([2])[0]
    export.write_channel_text(channel, f"hdfs://{auth}/data/Dod/raw.txt")  # scheme-routed
    ours = store.files["/data/Dod/raw.txt"]
    jax_rec = jax_bv.load_recording(f"hdfs://{auth}/data/DoD/synth_01.eeg",
                                    filesystem=jax_remote.filesystem_for("hdfs://x/y"))
    jax_export.write_channel_text(jax_rec.read_channels([2])[0],
                                  f"hdfs://{auth}/data/Dod/jax.txt")
    assert ours == store.files["/data/Dod/jax.txt"]
    lines = ours.decode("ascii").splitlines()
    assert len(lines) == channel.shape[0]
    np.testing.assert_array_equal(np.array([float(x) for x in lines]), channel)
