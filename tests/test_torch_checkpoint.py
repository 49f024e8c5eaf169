"""The port's checkpoint store against the JAX package's, on the CPU.

The port writes ``state.msgpack`` with its own codec (neither flax nor
msgpack is installed on the card's host). Its bytes must equal
``flax.serialization.to_bytes`` of the JAX package's host state, each
package must restore a directory the other wrote, and the crash
recovery (``.tmp-`` partial writes, ``.old-`` displaced steps) must
leave the same directory behind.
"""

import os

import numpy as np
import pytest
import torch
from flax import serialization

from eeg_dataanalysispackage_tpu.checkpoint.manager import CheckpointManager as JaxManager
from eeg_dataanalysispackage_tpu_torch.checkpoint import codec
from eeg_dataanalysispackage_tpu_torch.checkpoint.manager import CheckpointManager


def _candidate_state(seed=0, d=48, cap=1024):
    """A lifecycle candidate's checkpoint state at full size: the
    196,608-byte ring needs msgpack's 32-bit bin and ext lengths."""
    rng = np.random.RandomState(seed)
    return {
        "w": rng.randn(d).astype(np.float32),
        "converged": np.asarray(False),
        "n_updates": np.asarray(7, np.int32),
        "t": np.asarray(140, np.int64),
        "features": rng.randn(cap, d).astype(np.float32),
        "labels": (rng.rand(cap) > 0.5).astype(np.float32),
        "mask": np.ones(cap, np.float32),
        "rows_seen": np.asarray(1500, np.int64),
    }


STATES = {
    "candidate": _candidate_state(),
    "small_ring": _candidate_state(seed=1, d=8, cap=16),
    "empty": {"a": np.zeros((0,), np.float32)},
    "long_key_int16": {"k" * 40: np.arange(300, dtype=np.int16).reshape(3, 100)},
    "scalars": {"f": np.asarray(1.5), "b": np.asarray(True), "u": np.asarray(200, np.uint8),
                "i": np.asarray(-3, np.int32)},
    "shapes": {"z": np.ones((2, 3, 70000 // 6), np.float32), "x": np.ones((1, 1, 1, 1))},
    "many_keys": {f"k{i:02d}": np.asarray(i, np.int64) for i in range(20)},
}


def _host(state):
    """The JAX package's manager's host copy of ``state`` (it maps the
    state through ``jax.tree_util``, which rebuilds a dict in sorted key
    order)."""
    import jax

    return jax.tree_util.tree_map(np.asarray, state)


@pytest.mark.parametrize("name", list(STATES))
def test_codec_bytes_equal_flax(name):
    state = STATES[name]
    assert codec.to_bytes(state) == serialization.to_bytes(_host(state))


@pytest.mark.parametrize("name", list(STATES))
def test_codec_reads_flax_bytes(name):
    state = STATES[name]
    got = codec.from_bytes(serialization.to_bytes(_host(state)))
    assert sorted(got) == sorted(state)
    for key, value in state.items():
        value = np.asarray(value)
        assert got[key].dtype == value.dtype and got[key].shape == value.shape
        assert got[key].tobytes() == value.tobytes()


@pytest.mark.parametrize("bad", [b"", b"\x81", b"\x81\xa1w\xc4\x00", b"\x80\x00"])
def test_codec_refuses_what_it_did_not_write(bad):
    with pytest.raises(ValueError):
        codec.from_bytes(bad)


def _files(directory):
    out = {}
    for root, _dirs, files in os.walk(directory):
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, directory)] = fh.read()
    return out


def test_saved_directories_are_byte_equal(tmp_path):
    """The same saves through both managers leave byte-equal trees,
    retention included."""
    extra = {"d": 48, "batches": 3, "generation": 0}
    ours = CheckpointManager(str(tmp_path / "ours"), max_to_keep=2)
    theirs = JaxManager(str(tmp_path / "theirs"), max_to_keep=2)
    for step in (1, 2, 3):
        state = _candidate_state(seed=step)
        ours.save(step, state, extra=extra)
        theirs.save(step, state, extra=extra)
    assert ours.all_steps() == theirs.all_steps() == [2, 3]
    assert _files(str(tmp_path / "ours")) == _files(str(tmp_path / "theirs"))


def test_tensor_leaves_are_saved_from_the_host(tmp_path):
    state = {"w": torch.arange(4, dtype=torch.float32), "t": np.asarray(3, np.int64)}
    ours = CheckpointManager(str(tmp_path))
    ours.save(1, state)
    with open(tmp_path / "step_00000001" / "state.msgpack", "rb") as f:
        assert f.read() == serialization.to_bytes(
            _host({"w": np.arange(4, dtype=np.float32), "t": np.asarray(3, np.int64)}))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_cross_restore(tmp_path, writer, reader):
    make = {"jax": JaxManager, "port": CheckpointManager}
    state = _candidate_state(seed=9)
    make[writer](str(tmp_path)).save(4, state, extra={"d": 48, "batches": 4})
    manager = make[reader](str(tmp_path))
    assert manager.latest_step() == 4
    assert manager.read_metadata()["extra"] == {"d": 48, "batches": 4}
    template = _candidate_state(seed=0)
    restored, metadata = manager.restore(template)
    assert metadata == {"step": 4, "extra": {"d": 48, "batches": 4}}
    for key, value in state.items():
        assert np.asarray(restored[key]).tobytes() == value.tobytes()
        assert np.asarray(restored[key]).dtype == value.dtype


def test_restore_refuses_a_template_key_the_checkpoint_lacks(tmp_path):
    for make in (CheckpointManager, JaxManager):
        d = str(tmp_path / make.__module__.split(".")[0])
        manager = make(d)
        manager.save(1, {"w": np.zeros(3, np.float32)})
        with pytest.raises(ValueError, match="not present in state dict") as err:
            manager.restore({"w": np.zeros(3, np.float32), "extra_key": np.zeros(1)})
        assert "extra_key" in str(err.value)


@pytest.mark.parametrize("make", [CheckpointManager, JaxManager], ids=["port", "jax"])
def test_empty_directory_has_no_step(tmp_path, make):
    manager = make(str(tmp_path))
    assert manager.latest_step() is None and manager.all_steps() == []
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        manager.restore({"w": np.zeros(1)})
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        manager.read_metadata()


def _crash_layout(directory, step_exists):
    """A directory as a crash mid-save leaves it: a partial ``.tmp-``
    write, and a displaced ``.old-`` step whose final directory exists
    (the overwrite completed) or not (the crash hit between renames)."""
    manager = CheckpointManager(directory)
    manager.save(1, {"w": np.full(3, 1.0, np.float32)})
    manager.save(2, {"w": np.full(3, 2.0, np.float32)})
    os.makedirs(os.path.join(directory, ".tmp-00000003"))
    with open(os.path.join(directory, ".tmp-00000003", "state.msgpack"), "wb") as f:
        f.write(b"\x81")  # truncated
    if step_exists:
        manager.save(5, {"w": np.full(3, 5.0, np.float32)})
        os.makedirs(os.path.join(directory, ".old-00000005"))
    else:
        os.rename(os.path.join(directory, "step_00000002"),
                  os.path.join(directory, ".old-00000002"))


@pytest.mark.parametrize("step_exists", [False, True])
def test_crash_recovery_matches_jax(tmp_path, step_exists):
    """Opening a crashed directory repairs it the same way in both
    packages: partial writes go, a displaced step comes back (or goes
    when its overwrite completed), and the latest step restores."""
    for who, make in (("port", CheckpointManager), ("jax", JaxManager)):
        d = str(tmp_path / who)
        _crash_layout(d, step_exists)
        manager = make(d)
        assert not any(n.startswith((".tmp-", ".old-")) for n in os.listdir(d))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))
    ours = CheckpointManager(str(tmp_path / "port"))
    latest = ours.latest_step()
    assert latest == (5 if step_exists else 2)
    restored, _ = ours.restore({"w": np.zeros(3, np.float32)})
    assert restored["w"].tolist() == [float(latest)] * 3


def test_overwrite_displaces_then_replaces(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    manager.save(1, {"w": np.zeros(2, np.float32)}, extra={"v": 1})
    manager.save(1, {"w": np.ones(2, np.float32)}, extra={"v": 2})
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]
    restored, metadata = manager.restore({"w": np.zeros(2, np.float32)})
    assert restored["w"].tolist() == [1.0, 1.0] and metadata["extra"] == {"v": 2}


def test_clear_and_retention(tmp_path):
    manager = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in range(1, 6):
        manager.save(step, {"w": np.asarray(step, np.int64)})
    assert manager.all_steps() == [4, 5]
    manager.clear()
    assert manager.all_steps() == [] and manager.latest_step() is None
    # a step directory without its state file is not a step
    os.makedirs(tmp_path / "step_00000009")
    assert manager.all_steps() == []


# -- nested maps: a neural network's parameter tree ---------------------------


def _flax_nn_tree():
    """``model.init``'s tree of the JAX package's network: eleven layers
    (``layer10`` sorts before ``layer2``) and an LSTM's eight gates."""
    import jax
    import jax.numpy as jnp

    from eeg_dataanalysispackage_tpu.models import nn as jax_nn

    types = ("dense",) * 9 + ("graves_lstm", "output")
    net = jax_nn._Net(types, (3,) * 10 + (2,), ("relu",) * 10 + ("softmax",), (0.0,) * 11,
                      "xavier")
    rng = jax.random.PRNGKey(0)
    return net.init({"params": rng, "dropout": rng}, jnp.zeros((1, 5)), train=False)


@pytest.mark.parametrize("order", ["init", "sorted"])
def test_codec_nested_maps_equal_flax(order):
    """A nested tree in ``model.init``'s creation order (``keep_order``)
    or in a jax.tree_util-rebuilt tree's sorted order (the default):
    bytes equal ``flax.serialization.to_bytes``; ``from_bytes`` reads the
    tree back in the file's order."""
    import jax

    tree = _flax_nn_tree()
    if order == "sorted":
        tree = jax.tree_util.tree_map(lambda a: a, tree)

    def host(t):
        return {k: host(v) if isinstance(v, dict) else np.asarray(v) for k, v in t.items()}

    want = serialization.to_bytes(tree)
    got = codec.to_bytes(host(tree), keep_order=(order == "init"))
    assert got == want
    back = codec.from_bytes(want)
    assert list(back["params"]) == list(tree["params"])
    assert list(back["params"]["layer10"]) == ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"]
    assert back["params"]["layer10"]["ii"]["kernel"].tobytes() == np.asarray(
        tree["params"]["layer10"]["ii"]["kernel"]).tobytes()
    assert codec.to_bytes(back, keep_order=True) == want
