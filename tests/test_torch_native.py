"""The port's native host kernels (``csrc/eeg_host.cc`` through
``io/native.py``) against its numpy paths and the JAX package's arrays,
as the JAX package's ``tests/test_native.py`` holds its own.

The int16 demux in both layouts, the window gather with the float32
baseline, the valid mask and the balance scan are bit-equal to the port's
numpy paths and to the JAX package's; the parsers give the JAX package's
``Header``/``Marker`` fields on the synthetic sessions, the edge cases
and the exotic text the C++ side routes to the Python parser, and a
bounded differential fuzz agrees. ``EEG_TPU_NATIVE=0`` selects the numpy
paths with the same batches; a failing compiler raises with its output.
The library builds with ``g++`` into ``_build/`` at first use.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from eeg_dataanalysispackage_tpu.epochs import extractor as jax_extractor
from eeg_dataanalysispackage_tpu.io import brainvision as jax_bv
from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu_torch.epochs import extractor
from eeg_dataanalysispackage_tpu_torch.io import brainvision, native, provider
from eeg_dataanalysispackage_tpu_torch.ops import cuda_build

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402
import _torch_sessions  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available()


def _fields(obj):
    if isinstance(obj, list):
        return [_fields(o) for o in obj]
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("vectorized", [False, True])
def test_demux_equals_numpy_and_the_jax_package(vectorized):
    rng = np.random.RandomState(7 + vectorized)
    raw = rng.randint(-32768, 32768, size=(5000, 8), dtype=np.int16)
    indices, res = [3, 0, 5], [0.1, 1.0, 0.0488281]
    res32 = np.asarray(res, np.float32)
    expect = (raw[:, indices].T.astype(np.float32) * res32[:, None]).astype(np.float64)
    got = native.demux_int16(np.ascontiguousarray(raw.T) if vectorized else raw, indices, res,
                             vectorized=vectorized)
    assert got.dtype == np.float64 and np.array_equal(got, expect)
    # through a Recording in each layout, against the JAX package's
    header = jax_bv.Header("a.eeg", "a.vmrk", "BINARY",
                           "VECTORIZED" if vectorized else "MULTIPLEXED", 8, 1000.0, "INT_16",
                           [jax_bv.ChannelInfo(i + 1, f"c{i}", "", 0.5, "uV") for i in range(8)])
    stored = raw if not vectorized else np.ascontiguousarray(raw.T).T
    theirs = jax_bv.Recording(header, [], stored).read_channels(indices)
    ours = brainvision.Recording(header, [], stored).read_channels(indices)
    assert np.array_equal(ours, theirs)


def test_demux_refuses_an_out_of_range_channel():
    with pytest.raises(IndexError):
        native.demux_int16(np.zeros((10, 3), np.int16), [3], [1.0])


@pytest.mark.parametrize("pre,post", [(100, 750), (7, 33)])
def test_gather_baseline_equals_numpy_and_the_jax_package(pre, post):
    rng = np.random.RandomState(9)
    channels = rng.randn(3, 2000) * 1000.0 + 300.0
    # out-of-range starts (negative, past the end) and a tail overhang
    positions = np.array([-50, 100, 150, 1990, 1500, 2150, 2090, pre], dtype=np.int64)
    epochs, valid = native.gather_baseline(channels, positions, pre, post)
    windows, valid_np = extractor.gather_windows(channels, positions, pre, post)
    want = extractor.baseline_correct_f32(windows, pre)[..., pre:].astype(np.float64)
    assert np.array_equal(valid, valid_np) and np.array_equal(epochs, want)
    j_windows, j_valid = jax_extractor.gather_windows(channels, positions, pre, post)
    j_epochs = jax_extractor.baseline_correct_f32(j_windows, pre)[..., pre:].astype(np.float64)
    assert np.array_equal(valid, j_valid) and np.array_equal(epochs, j_epochs)


def test_a_window_past_the_native_buffer_goes_to_numpy():
    assert native.gather_baseline(np.zeros((1, 10)), np.zeros(1, np.int64), 100,
                                  native.MAX_WINDOW) is None


def test_balance_scan_equals_the_loop_and_the_jax_package(monkeypatch):
    is_target = np.random.RandomState(10).rand(500) > 0.8
    counters = np.array([3, 1], dtype=np.int64)
    keep = native.balance_scan(is_target, counters)
    ours = extractor.BalanceState()
    ours.n_targets, ours.n_nontargets = 3, 1
    theirs = jax_extractor.BalanceState()
    theirs.n_targets, theirs.n_nontargets = 3, 1
    assert np.array_equal(ours.scan(is_target), keep)
    assert np.array_equal(theirs.scan(is_target), keep)
    monkeypatch.setenv(native.ENV_NATIVE, "0")
    loop = extractor.BalanceState()
    loop.n_targets, loop.n_nontargets = 3, 1
    assert np.array_equal(loop.scan(is_target), keep)
    assert (ours.n_targets, ours.n_nontargets) == (loop.n_targets, loop.n_nontargets) == (
        theirs.n_targets, theirs.n_nontargets) == tuple(counters)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("native_session"))
    lines = []
    for i, guessed in enumerate((3, 5)):
        _synthetic.write_recording(d, name=f"n_{i}", n_markers=80, guessed=guessed, seed=20 + i)
        lines.append(f"n_{i}.eeg {guessed}")
    lines.append(_torch_sessions.write_coded_recording(
        d, "vec", "IEEE_FLOAT_32", n_markers=20, guessed=4, seed=3, orientation="VECTORIZED"))
    with open(os.path.join(d, "info.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return d


def test_parsers_give_the_jax_packages_fields_on_the_sessions(session):
    for name in sorted(os.listdir(session)):
        path = os.path.join(session, name)
        with open(path, errors="replace") as f:
            text = f.read()
        if name.endswith(".vhdr"):
            got, py = native.parse_vhdr(text), brainvision.parse_vhdr_py(text)
            want = jax_bv.parse_vhdr_py(text)
        elif name.endswith(".vmrk"):
            got, py = native.parse_vmrk(text), brainvision.parse_vmrk_py(text)
            want = jax_bv.parse_vmrk_py(text)
        else:
            continue
        assert got is not None, name
        assert got == py and _fields(got) == _fields(want), name


@pytest.mark.parametrize("native_flag", ["1", "0"])
def test_host_batches_equal_the_jax_package_either_way(session, monkeypatch, native_flag):
    """load() through the native parser, demux, gather and scan, and
    through the numpy paths (EEG_TPU_NATIVE=0): the JAX package's epochs,
    targets and stimulus indices, bit for bit."""
    info = os.path.join(session, "info.txt")
    want = jax_provider.OfflineDataProvider([info], workers=1).load()
    monkeypatch.setenv(native.ENV_NATIVE, native_flag)
    assert native.available() is (native_flag == "1")
    got = provider.OfflineDataProvider([info], device="cpu").load()
    assert got.epochs.shape[0] > 0
    for field in ("epochs", "targets", "stimulus_indices"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field


EDGE_VHDR = (
    "; comment line\n"
    "Brain Vision Data Exchange Header File Version 1.0\n"
    "[Common Infos]\r\n"
    "DataFile=a.eeg\n"
    "MarkerFile=a.vmrk\n"
    "  ; indented comment\n"
    "DataOrientation=VECTORIZED\n"
    "NumberOfChannels= 12 \n"
    "SamplingInterval=500\n"
    "[Binary Infos]\n"
    "BinaryFormat=IEEE_FLOAT_32\n"
    "[Channel Infos]\n"
    "Ch10=Late,,0.5,uV\n"
    "Ch2=Cz,REF,,mV\n"
    "Ch1=Fp\\1z,,0.1\n"
    "Ch2=Cz2,REF2,2.0,mV\n"
    "[Common Infos]\n"
    "DataFile=b.eeg\n"
)
EDGE_VMRK = (
    "[Marker Infos]\n"
    "Mk2=Stimulus,S  2,2000,1,0\n"
    "Mk1=New Segment,,1,1,0,20130611104808482924\n"
    "Mk10=Stimulus,S10,9000,1,0\n"
    "Mk3=Stimulus,S\\1x,notanint,1,0\n"
    "Codepage=UTF-8\n"
)


def test_parser_edge_semantics_equal_the_jax_package():
    got = native.parse_vhdr(EDGE_VHDR)
    assert got is not None and _fields(got) == _fields(jax_bv.parse_vhdr_py(EDGE_VHDR))
    assert got.data_file == "b.eeg" and [c.name for c in got.channels] == ["Fp,z", "Cz2", "Late"]
    markers = native.parse_vmrk(EDGE_VMRK)
    assert markers is not None and _fields(markers) == _fields(jax_bv.parse_vmrk_py(EDGE_VMRK))
    assert [m.stimulus_index() for m in markers] == [-1, 1, -1, 9]


@pytest.mark.parametrize("kind,text", [
    ("vhdr", "[Channel Infos]\nCh1=" + "x" * 400 + ",,0.1,uV\n"),  # oversized name
    ("vhdr", "[Common Infos]\rDataFile=x.eeg\r"),  # lone \r terminators
    ("vhdr", "[Common Infos]\vDataFile=y.eeg\n"),
    ("vhdr", "[Channel Infos]\nCh١=Fz,,0.1,uV\n"),  # a Unicode digit
    ("vhdr", "[Common Infos]\nDataFile =x.eeg\n"),  # a Unicode space
    ("vhdr", "[Channel Infos]\nCh99999999999999999999=Fz,,0.1,uV\n"),
    ("vhdr", "[Common Infos]\nDataFile=a\x00b.eeg\n"),  # NUL
    ("vhdr", "[Common Infos]\nDataFile=a\udcffb.eeg\n"),  # a lone surrogate
    ("vmrk", "[Marker Infos]\nMk1=Stimulus,S  1,99999999999999999999,1,0\n"),
    ("vmrk", "[Marker Infos]\nMk1=Stimulus,S  1,1 ,1,0\n"),
])
def test_exotic_text_routes_to_the_python_parser(kind, text):
    """Text the C++ parser cannot represent exactly returns None there,
    and the routed parse equals the JAX package's."""
    if kind == "vhdr":
        assert native.parse_vhdr(text) is None
        assert _fields(brainvision.parse_vhdr(text)) == _fields(jax_bv.parse_vhdr(text))
    else:
        assert native.parse_vmrk(text) is None
        assert _fields(brainvision.parse_vmrk(text)) == _fields(jax_bv.parse_vmrk(text))


@pytest.mark.parametrize("text", ["[Channel Infos]\nCh1=Fz,,zzz,uV\n",
                                  "[Common Infos]\nSamplingInterval=nan(123)\n"])
def test_text_python_rejects_is_rejected(text):
    assert native.parse_vhdr(text) is None
    with pytest.raises(ValueError):
        brainvision.parse_vhdr(text)
    with pytest.raises(ValueError):
        jax_bv.parse_vhdr(text)


_TOKENS = list("ab=;[]\\,.0123456789 \t") + ["Ch", "Mk", "_", "#", "[Common Infos]",
                                              "[Channel Infos]", "[Marker Infos]"]
_LINE = st.lists(st.sampled_from(_TOKENS), max_size=12).map("".join)
_KEYED = st.tuples(st.sampled_from(["Ch", "Mk"]), st.integers(0, 20), _LINE).map(
    lambda t: f"{t[0]}{t[1]}={t[2]}")
_TEXT = st.tuples(
    st.lists(st.tuples(st.one_of(_LINE, _KEYED), st.sampled_from(["\n", "\r\n"])), max_size=10),
    st.sampled_from(["", "trailing no-newline"]),
).map(lambda t: "".join(line + end for line, end in t[0]) + t[1])


@settings(max_examples=50, deadline=None, database=None)
@given(_TEXT)
def test_parser_differential_fuzz(text):
    """The C++ parse equals the Python parse (and the JAX package's), or
    declines; it never parses what Python rejects."""
    for parse, parse_py, jax_parse in ((native.parse_vhdr, brainvision.parse_vhdr_py,
                                        jax_bv.parse_vhdr_py),
                                       (native.parse_vmrk, brainvision.parse_vmrk_py,
                                        jax_bv.parse_vmrk_py)):
        try:
            want, err = parse_py(text), None
        except ValueError as e:
            want, err = None, e
        got = parse(text)
        if got is not None:
            assert err is None, (text, err)
            assert got == want and _fields(got) == _fields(jax_parse(text))


def test_a_failing_compiler_raises_with_its_output(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "CXX", "false")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="false failed to build eeg_host.cc"):
        native.available()
    monkeypatch.setattr(cuda_build, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="failed to build eeg_host.cc"):
        native.demux_int16(np.zeros((4, 2), np.int16), [0], [1.0])
    # the caller's explicit choice still selects the numpy paths
    monkeypatch.setenv(native.ENV_NATIVE, "0")
    assert native.demux_int16(np.zeros((4, 2), np.int16), [0], [1.0]) is None
    assert not os.listdir(tmp_path / "build")  # no partial library left behind


def test_the_library_is_built_from_the_ports_own_source():
    path = cuda_build.host_library_path("eeg_host")
    assert os.path.dirname(path) == cuda_build.BUILD_DIR and os.path.exists(path)
    assert "-ffast-math" not in cuda_build.HOST_FLAGS
    assert os.path.basename(path).startswith("eeg_host-")
