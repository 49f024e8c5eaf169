"""The port's native-RPC HDFS driver (``io/remote.NativeHdfsFileSystem``).

Twin of ``tests/test_hdfs_native.py``. ``HDFS_DRIVER=native`` routes
``hdfs://`` through libhdfs (pyarrow) for clusters with WebHDFS disabled.
The tests assume no Hadoop runtime (the card's host has none), so the
driver runs against a fake libhdfs layer behind the module-level ``_hadoop_connect``
seam: driver selection, the URI -> (host, port, path) mapping, the
FileSystem semantics, a whole session read and run through it, and the
actionable errors when pyarrow or libhdfs is absent (the same messages
as the JAX package's).
"""

import io
import os
import sys

import pytest

from eeg_dataanalysispackage_tpu.io import remote as jax_remote
from eeg_dataanalysispackage_tpu_torch.io import provider, remote
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _loopback  # noqa: E402


class _FakeStream(io.BytesIO):
    def __init__(self, store, path):
        super().__init__()
        self._store, self._path = store, path

    def __exit__(self, *exc):
        self._store[self._path] = self.getvalue()
        return super().__exit__(*exc)


class _FakeHadoopFS:
    """Just enough of pyarrow.fs.HadoopFileSystem for the adapter."""

    def __init__(self):
        self.files = {}
        self.dirs = set()

    def get_file_info(self, paths):
        from pyarrow import fs as pafs

        if isinstance(paths, pafs.FileSelector):
            base = paths.base_dir.rstrip("/") + "/"
            names = sorted({base + k[len(base):].split("/", 1)[0]
                            for k in self.files if k.startswith(base)})
            if not names:
                raise FileNotFoundError(paths.base_dir)
            return [pafs.FileInfo(n, type=pafs.FileType.File) for n in names]
        out = []
        for p in paths:
            if p in self.files:
                out.append(pafs.FileInfo(p, type=pafs.FileType.File, size=len(self.files[p])))
            elif p in self.dirs:
                out.append(pafs.FileInfo(p, type=pafs.FileType.Directory))
            else:
                out.append(pafs.FileInfo(p, type=pafs.FileType.NotFound))
        return out

    def delete_dir(self, p):
        prefix = p.rstrip("/")
        doomed = [k for k in self.files if k == prefix or k.startswith(prefix + "/")]
        if not doomed and prefix not in self.dirs:
            raise FileNotFoundError(p)
        for k in doomed:
            del self.files[k]

    def open_input_stream(self, p):
        return io.BytesIO(self.files[p])

    def open_output_stream(self, p):
        return _FakeStream(self.files, p)


@pytest.fixture
def fake_connect(monkeypatch):
    calls = []
    fake = _FakeHadoopFS()

    def connect(host, port, user):
        calls.append((host, port, user))
        return fake

    monkeypatch.setattr(remote, "_hadoop_connect", connect)
    return fake, calls


def test_driver_selection(monkeypatch):
    monkeypatch.delenv("HDFS_DRIVER", raising=False)
    assert isinstance(remote.filesystem_for("hdfs://nn:8020/x"), remote.WebHdfsFileSystem)
    monkeypatch.setenv("HDFS_DRIVER", "native")
    assert isinstance(remote.filesystem_for("hdfs://nn:8020/x"), remote.NativeHdfsFileSystem)
    monkeypatch.setenv("HDFS_DRIVER", "bogus")
    with pytest.raises(ValueError, match="HDFS_DRIVER"):
        remote.filesystem_for("hdfs://nn:8020/x")


def test_round_trip_and_authority_mapping(fake_connect):
    fake, calls = fake_connect
    fs = remote.NativeHdfsFileSystem(user="eeg")
    uri = "hdfs://namenode:9000/data/infoTrain.txt"
    assert not fs.exists(uri)
    fs.write_bytes(uri, b"a;b;c\n")
    assert fs.exists(uri)
    assert fs.read_bytes(uri) == b"a;b;c\n"
    assert fs.read_text(uri) == "a;b;c\n"
    # one cached connection, dialed with the URI's RPC authority
    assert calls == [("namenode", 9000, "eeg")]


def test_default_port_and_default_fs(fake_connect):
    fake, calls = fake_connect
    fs = remote.NativeHdfsFileSystem()
    fs.write_bytes("hdfs://nn/x", b"1")  # no port -> 8020 (Const.java:39)
    fs.write_bytes("hdfs:///y", b"2")  # the default-FS form -> libhdfs 'default'
    assert [c[:2] for c in calls] == [("nn", 8020), ("default", 0)]


def test_directory_and_missing_semantics(fake_connect):
    fake, _ = fake_connect
    fake.dirs.add("/d")
    fs = remote.NativeHdfsFileSystem()
    with pytest.raises(IsADirectoryError):
        fs.read_bytes("hdfs://nn/d")
    with pytest.raises(FileNotFoundError):
        fs.read_bytes("hdfs://nn/nope")


def test_list_dir_and_delete_dir(fake_connect):
    fake, _ = fake_connect
    fs = remote.NativeHdfsFileSystem()
    fs.write_bytes("hdfs://nn/m/metadata/part-00000", b"x")
    fs.write_bytes("hdfs://nn/m/data/part-r-0.gz.parquet", b"y")
    assert fs.list_dir("hdfs://nn/m") == ["data", "metadata"]
    assert fs.list_dir("hdfs://nn/m/metadata") == ["part-00000"]
    with pytest.raises(FileNotFoundError):
        fs.list_dir("hdfs://nn/nope")
    fs.delete_dir("hdfs://nn/m")
    fs.delete_dir("hdfs://nn/m")  # a missing target is fine
    assert fake.files == {}


def test_session_over_the_native_driver_equals_local(fake_connect, monkeypatch, tmp_path):
    """info_file=hdfs://... with HDFS_DRIVER=native: the provider's reads
    and the model's save and load go through the libhdfs seam, and the
    statistics equal the local run's."""
    fake, _ = fake_connect
    session = _loopback.write_remote_session(str(tmp_path))
    store = _loopback.Store()
    store.add_tree(str(tmp_path), "/data")
    fake.files.update(store.files)
    monkeypatch.setenv("HDFS_DRIVER", "native")
    q = "fe=dwt-8-fused&train_clf=logreg&save_clf=true&save_name=hdfs://nn/models/m"
    got = PipelineBuilder(f"info_file=hdfs://nn/data/infoTrain.txt&{q}", device="cpu").execute()
    assert "/models/m.npz" in fake.files
    local = PipelineBuilder(f"info_file={session}&fe=dwt-8-fused&train_clf=logreg",
                            device="cpu").execute()
    assert str(got) == str(local)
    loaded = PipelineBuilder("info_file=hdfs://nn/data/infoTrain.txt&fe=dwt-8-fused"
                             "&load_clf=logreg&load_name=hdfs://nn/models/m",
                             device="cpu").execute()
    assert loaded.num_patterns > 0
    batch = provider.OfflineDataProvider(["hdfs://nn/data/infoTrain.txt"], device="cpu").load()
    assert batch.epochs.shape[0] > 0


def test_non_hdfs_uri_rejected(fake_connect):
    with pytest.raises(ValueError, match="hdfs://"):
        remote.NativeHdfsFileSystem().read_bytes("http://x/y")


def test_missing_native_runtime_error_is_actionable():
    """Without libhdfs the real connect fails fast with the WebHDFS
    pointer, as the JAX package's does."""
    pytest.importorskip("pyarrow.fs")
    with pytest.raises(remote.RemoteIOError, match="WebHDFS") as ours:
        remote._hadoop_connect("localhost", 1, None)
    with pytest.raises(jax_remote.RemoteIOError) as theirs:
        jax_remote._hadoop_connect("localhost", 1, None)
    # the loader's own words in the parentheses differ between attempts
    for err in (ours.value, theirs.value):
        msg = str(err)
        assert msg.startswith("native HDFS connect to localhost:1 failed (")
        assert msg.endswith("); the libhdfs runtime (libhdfs.so + CLASSPATH from a Hadoop "
                            "install) must be present — or unset HDFS_DRIVER to use WebHDFS")


def test_missing_pyarrow_error_is_actionable(monkeypatch):
    """The card's host has no pyarrow: HDFS_DRIVER=native raises the JAX
    package's actionable message, not an ImportError."""
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.fs", None)
    with pytest.raises(remote.RemoteIOError, match="needs pyarrow") as ours:
        remote._hadoop_connect("nn", 8020, None)
    with pytest.raises(jax_remote.RemoteIOError) as theirs:
        jax_remote._hadoop_connect("nn", 8020, None)
    assert str(ours.value) == str(theirs.value)
