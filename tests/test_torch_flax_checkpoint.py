"""The JAX package's ``net-epoch-N.msgpack`` checkpoints read by the port.

``utils/msgpack_lite.py`` decodes the msgpack subset flax writes, without
msgpack or flax, and ``train/checkpoints.py::load_flax_checkpoint`` hands
the tree to the weight bridge:

- the decoder gives ``msgpack.unpackb``'s objects over every type of the
  subset, and ``flax.serialization.msgpack_restore``'s trees (ndarrays,
  numpy scalars, bfloat16 leaves as ``torch.bfloat16`` with the same
  bits, chunked arrays, tuples as ``{"0": ...}`` maps); anything outside
  the subset, and a truncated buffer, raises;
- a tiny student's ``TrainState`` written by the JAX ``save_checkpoint``
  comes back with every parameter, batch statistic and velocity tensor
  bitwise equal after the bridge, and its forward gives the JAX logits
  within 1e-4 x max|logit|; a truncated file raises
  ``CorruptCheckpointError``.
"""

import flax.serialization as ser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu.models.vggm import VGGMStudent as JaxVGGM
from mcncrossmodalemotions_tpu.train import checkpoints as jckpt
from mcncrossmodalemotions_tpu.train.state import TrainState as JaxTrainState
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.train import checkpoints as ckpt
from mcncrossmodalemotions_torch.utils import msgpack_lite
from mcncrossmodalemotions_torch.zoo import (
    random_student_variables,
    student_params_from_flax,
    student_state_dict_from_flax,
)

FC6, FC7 = 64, 32


def _same(a, b, where=""):
    """Equal trees: same keys and types; arrays of the same dtype, shape
    and bits (a torch bfloat16 leaf against numpy's ml_dtypes one)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16 and str(np.asarray(b).dtype) == "bfloat16"
        assert tuple(a.shape) == np.shape(b), where
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype, where
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), where
    else:
        assert type(a) is type(b) and (a == b or a != a and b != b), where


SUBSET = [  # each msgpack type of the subset, at each width
    None, True, False, 0, 5, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
    -2**63, 0.5, -1e300, float("inf"), float("nan"), "", "a" * 31, "b" * 32,
    "c" * 256, "d" * 70000, "ünïcode", b"", b"\x00" * 300, b"e" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {str(i): None for i in range(70000)}, {1: "int key", b"b": "bin key"},
]


@pytest.mark.parametrize("obj", SUBSET, ids=range(len(SUBSET)))
def test_decoder_gives_msgpacks_objects(obj):
    blob = msgpack.packb(obj, use_bin_type=True)
    _same(msgpack_lite.unpackb(blob), msgpack.unpackb(blob, raw=False,
                                                      strict_map_key=False))
    blob32 = msgpack.packb(obj, use_single_float=True, use_bin_type=True)
    _same(msgpack_lite.unpackb(blob32), msgpack.unpackb(blob32, raw=False,
                                                        strict_map_key=False))


def _flax_tree():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "f64": rng.randn(2).astype(np.float64),
        "i8": rng.randint(-128, 127, (5,)).astype(np.int8),
        "u32": np.arange(6, dtype=np.uint32).reshape(2, 3, 1),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32),
        "scalar0d": np.float32(2.5) * np.ones((), np.float32),
        "npscalar": {"f": np.float32(-0.75), "i": np.int64(-2**40),
                     "b": np.bool_(True)},
        "bf16": jnp.asarray(rng.randn(4, 3), jnp.bfloat16),
        "bf16_scalar": np.asarray(jnp.asarray(1.5, jnp.bfloat16))[()],
        "tuple": (np.ones(2, np.float32), 3, "x"),
        "nested": {"list": [np.int32(4), None, True]},
    }


def test_decoder_gives_flaxs_trees():
    blob = ser.to_bytes(_flax_tree())  # tuples and lists as {"0": ...}
    got, ref = msgpack_lite.unpackb(blob), ser.msgpack_restore(blob)
    _same(got, ref)
    assert isinstance(got["bf16"], torch.Tensor)
    assert got["bf16"].dtype == torch.bfloat16 and got["bf16"].shape == (4, 3)
    assert msgpack_lite.as_tuple(got["tuple"])[1] == 3
    assert list(got["nested"]["list"]) == ["0", "1", "2"]


def test_chunked_arrays_are_joined(monkeypatch):
    rng = np.random.RandomState(1)
    big = rng.randn(7, 5).astype(np.float32)
    bigbf = jnp.asarray(rng.randn(3, 11), jnp.bfloat16)
    # the layout built by hand: {"__msgpack_chunked_array__", shape, chunks}
    flat = big.reshape(-1)
    hand = {"a": {"__msgpack_chunked_array__": True, "shape": {"0": 7, "1": 5},
                  "chunks": {"0": flat[:20], "1": flat[20:]}}}
    blob = ser.msgpack_serialize(hand)
    got = msgpack_lite.unpackb(blob)
    _same(got, ser.msgpack_restore(blob))
    np.testing.assert_array_equal(got["a"], big)
    # flax cuts an array over MAX_CHUNK_SIZE bytes into chunks; a small
    # limit makes it chunk these
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 48)
    blob = ser.msgpack_serialize({"w": big, "b": bigbf, "s": np.ones(2, np.int8)})
    raw = msgpack_lite.unpackb(blob, chunked=False)
    assert raw["w"][msgpack_lite.CHUNKED] is True and len(raw["w"]["chunks"]) == 3
    got = msgpack_lite.unpackb(blob)
    _same(got, ser.msgpack_restore(blob))
    np.testing.assert_array_equal(got["w"], big)


@pytest.mark.parametrize("blob,what", [
    (ser.msgpack_serialize({"c": 1 + 2j}), "ext type 2"),
    (b"\xc1", "0xc1"),
    (msgpack.packb(1) + b"\x00", "after the object"),
    (msgpack.packb(msgpack.ExtType(1, msgpack.packb([[2], "float32", b"abc"]))),
     "bytes"),
    (msgpack.packb(msgpack.ExtType(1, msgpack.packb([[1], "object", b"12345678"]))),
     "object"),
    (msgpack.packb(msgpack.ExtType(1, msgpack.packb([1, 2]))), "not"),
    (b"\xa5abc", "truncated"),
])
def test_outside_the_subset_raises(blob, what):
    with pytest.raises(msgpack_lite.MsgpackError, match=what):
        msgpack_lite.unpackb(blob)


def _jax_state(seed: int, nested: bool, dtype=np.float32):
    """A JAX TrainState of a tiny student, velocity and step nonzero."""
    v = random_student_variables(seed=seed, fc6=FC6, fc7=FC7)
    rng = np.random.RandomState(seed + 100)
    velocity = jax.tree.map(
        lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), v["params"])
    if nested:
        v = {k: {"net": t} for k, t in v.items()}
        velocity = {"net": velocity}
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
    state = JaxTrainState.create(cast(v), jax.random.PRNGKey(seed))
    return state.replace(velocity=cast(velocity),
                         step=jnp.asarray(11 + seed, jnp.int32)), v, velocity


@pytest.mark.parametrize("nested", [False, True], ids=["bare", "pipeline"])
def test_jax_checkpoint_bitwise_after_the_bridge(tmp_path, nested):
    state, v, velocity = _jax_state(3, nested)
    path = jckpt.save_checkpoint(tmp_path, 4, state, {"val": {"classerror": 0.5}})
    assert path.name == "net-epoch-4.msgpack"
    record = ckpt.load_flax_checkpoint(path)
    assert record["step"] == 14
    want = student_state_dict_from_flax(v)
    assert list(record["model"]) == list(want)
    for k, t in want.items():
        got = record["model"][k]
        assert got.dtype == t.dtype and torch.equal(got, t), k
    for k, t in student_params_from_flax(velocity).items():
        assert torch.equal(record["velocity"][k], t), k
    prefix = "net." if nested else ""
    assert set(record["velocity"]) == {
        prefix + n for n, _ in VGGMStudent(fc6_features=FC6, fc7_features=FC7)
        .named_parameters()}
    # the JAX restore of the same file, leaf by leaf
    restored = jckpt.load_checkpoint(path, state)
    jvel = student_params_from_flax(jax.device_get(restored.velocity))
    for k, t in jvel.items():
        assert torch.equal(record["velocity"][k], t), k


def test_jax_checkpoint_forward_logits(tmp_path):
    state, v, _ = _jax_state(5, nested=False)
    path = jckpt.save_checkpoint(tmp_path, 1, state)
    model = VGGMStudent(fc6_features=FC6, fc7_features=FC7, dtype=torch.float32)
    model.load_state_dict(ckpt.load_flax_checkpoint(path)["model"])
    x = np.random.RandomState(0).randn(2, 512, 100, 1).astype(np.float32)
    jm = JaxVGGM(fc6_features=FC6, fc7_features=FC7, dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jm.apply(state.variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), train=False).numpy()
    scale = np.abs(ref).max()
    assert scale > 0.1 and np.abs(got - ref).max() <= 1e-4 * scale


def test_bfloat16_checkpoint_widens_exactly(tmp_path):
    state, v, _ = _jax_state(6, nested=True, dtype=jnp.bfloat16)
    path = jckpt.save_checkpoint(tmp_path, 2, state)
    record = ckpt.load_flax_checkpoint(path)
    want = student_state_dict_from_flax(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), v))
    assert any(isinstance(leaf, torch.Tensor) for leaf in jax.tree.leaves(
        ckpt.msgpack_lite.unpackb(path.read_bytes())["params"]))
    for k, t in want.items():
        assert record["model"][k].dtype == t.dtype
        assert torch.equal(record["model"][k], t), k


@pytest.mark.parametrize("keep", [0, 1, 100, -1])
def test_truncated_or_garbled_checkpoint_raises(tmp_path, keep):
    state, _, _ = _jax_state(7, nested=False)
    path = jckpt.save_checkpoint(tmp_path, 1, state)
    blob = path.read_bytes()
    path.write_bytes(blob[:keep] if keep >= 0 else blob[:-1] + b"\xc1\x00")
    with pytest.raises(ckpt.CorruptCheckpointError):
        ckpt.load_flax_checkpoint(path)


def test_a_tree_that_is_not_a_train_state_raises(tmp_path):
    path = tmp_path / "net-epoch-1.msgpack"
    path.write_bytes(ser.msgpack_serialize({"params": {}}))
    with pytest.raises(KeyError, match="not a TrainState"):
        ckpt.load_flax_checkpoint(path)
