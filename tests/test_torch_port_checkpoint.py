"""The port's checkpoint reader, parameter converter and import isolation.

The port reads the JAX package's checkpoints with its own msgpack decoder
(no ``msgpack``, no ``flax``); here it is held bit for bit against
``flax.serialization.msgpack_restore`` and against ``msgpack.packb``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
from flax import serialization

from dbsr_tpu.training.checkpoint import _read as jax_read
from dbsr_tpu_torch.models.dbsr import dbsrnet_cvpr2021
from dbsr_tpu_torch.training.checkpoint import msgpack_unpack, read_checkpoint
from dbsr_tpu_torch.utils.convert import params_from_flax

REPO = Path(__file__).resolve().parents[1]
CKPTS = ["dbsr_tpu/artifacts/campaigns/dbsr_campaign_r5_best_params.ckpt",
         "dbsr_tpu/artifacts/align_lite_params.ckpt"]


@pytest.mark.parametrize("path", CKPTS)
def test_reader_is_bit_identical_to_flax(path):
    header, tree = read_checkpoint(str(REPO / path))
    jheader, blob = jax_read(str(REPO / path))
    want = serialization.msgpack_restore(blob)
    assert header == jheader
    got_leaves = jax.tree_util.tree_leaves_with_path(tree)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (p, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65536, 2 ** 33, -1, -32, -33, -129, -40000,
    -2 ** 40, 1.5, -0.25, True, False, None, "", "x" * 31, "y" * 300,
    "z" * 70000, b"\x00\x01", b"b" * 300, list(range(20)), [[1, [2]], "a"],
    {str(i): i for i in range(20)}, {"a": {"b": [1.0, None]}},
])
def test_msgpack_primitives_match_msgpack(value):
    assert msgpack_unpack(msgpack.packb(value), flax_tree=False) == value


def test_msgpack_arrays_scalars_and_chunks_match_flax():
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "i": np.array([1, -2], np.int64), "s": np.float32(2.5),
            "c": 1 + 2j, "empty": np.zeros((0, 3), np.float32)}
    blob = serialization.msgpack_serialize(tree)
    got = msgpack_unpack(blob)
    want = serialization.msgpack_restore(blob)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    # flax's chunked form of an oversized array, built at a small size
    arr = np.arange(7, dtype=np.float32)
    blob = msgpack.packb({"w": serialization._chunk(arr)},
                         default=serialization._msgpack_ext_pack)
    np.testing.assert_array_equal(msgpack_unpack(blob)["w"], arr)
    np.testing.assert_array_equal(
        serialization.msgpack_restore(blob)["w"], arr)


def test_truncated_blob_raises():
    blob = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_unpack(blob[:-1])


def test_params_from_flax_key_map_and_layout():
    _, tree = read_checkpoint(str(REPO / CKPTS[0]))
    flax_params = tree["params"]["params"]
    state = params_from_flax(tree["params"])
    kernel = flax_params["encoder"]["embed"]["ConvBlock_0"]["Conv_0"]["kernel"]
    w = state["encoder.embed.ConvBlock_0.Conv_0.weight"]
    assert tuple(w.shape) == (64, 4, 3, 3)
    np.testing.assert_array_equal(w.numpy(), kernel.transpose(3, 2, 0, 1))
    assert "decoder.PixShuffleUpsampler_0.Conv_0.bias" not in state
    net = dbsrnet_cvpr2021()
    missing, unexpected = net.load_state_dict(state, strict=True)
    assert not missing and not unexpected
    assert len(state) == len(jax.tree_util.tree_leaves(flax_params))


def test_port_imports_neither_jax_nor_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dbsr_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    dbsr_tpu_torch.__path__, 'dbsr_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'msgpack',\n"
        "              'dbsr_tpu'))\n"
        "assert len(names) >= 15, names\n"
        "new = ['data.synthetic', 'data.procedural', 'ops.resample',\n"
        "       'ops.augment', 'ops.metrics', 'training.trainer',\n"
        "       'training.state', 'training.actors', 'run_training',\n"
        "       'configs.dbsr.default_synthetic', 'environment',\n"
        "       'configs.align_lite.pretrain_synthetic']\n"
        "missing = [n for n in new if 'dbsr_tpu_torch.' + n not in names]\n"
        "assert not missing, missing\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
