"""Released MatConvNet weights in the port: ``utils/mat73.py``,
``zoo/matconvnet.py`` and ``zoo/registry.py::load_pretrained_student``.

The releases are not in the repository, so each test writes its own
``.mat`` files, in both containers MATLAB ships (classic, through
``scipy.io``; ``-v7.3``, HDF5 through ``h5py``), with nonzero conv biases:

- the port's copies of the importer and the container helpers return the
  originals' arrays bit for bit, teacher layer maps included, and tell
  the containers apart without ``h5py``;
- ``load_pretrained_student`` folds the biases into the same BN means
  (bitwise) and gives the JAX ``load_pretrained_student`` + ``apply``'s
  logits (fp32, CPU) within 1e-4 x max|logit|, bare and as a pipeline.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu.ops.spectrogram import (
    waveform_to_input as jwaveform_to_input,
)
from mcncrossmodalemotions_tpu.utils import mat73 as jmat73
from mcncrossmodalemotions_tpu.zoo import load_pretrained_student as jload
from mcncrossmodalemotions_tpu.zoo import matconvnet as jmcn
from mcncrossmodalemotions_torch.models.pipeline import AudioStudentPipeline
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.utils import mat73
from mcncrossmodalemotions_torch.zoo import (
    load_pretrained_student,
    matconvnet,
    random_student_variables,
)
from mcncrossmodalemotions_torch.zoo.bridge import student_state_dict_from_flax

FC6, FC7 = 64, 32
CONTAINERS = ("classic", "v73")


def save_mat(path, named, container, meta=None):
    """``named`` ({param name: array}) as a DagNN ``net.params`` struct
    array; ``meta`` (averageImage, classes) as ``net.meta``."""
    if container == "classic":
        import scipy.io

        arr = np.zeros((len(named),), dtype=[("name", object), ("value", object)])
        for i, (name, value) in enumerate(named.items()):
            arr[i] = (name, value)
        net = {"params": arr}
        if meta is not None:
            net["meta"] = {"normalization": {"averageImage": meta["averageImage"]},
                           "classes": {"name": np.asarray(meta["classes"],
                                                          dtype=object)}}
        scipy.io.savemat(path, {"net": net})
        return
    import h5py

    ref = h5py.special_dtype(ref=h5py.Reference)

    def string(refs, key, s):
        return refs.create_dataset(key, data=np.asarray([[ord(c)] for c in s],
                                                        np.uint16)).ref

    with h5py.File(path, "w", userblock_size=512) as f:
        refs = f.create_group("#refs#")
        net = f.create_group("net")
        grp = net.create_group("params")
        names = grp.create_dataset("name", shape=(len(named), 1), dtype=ref)
        values = grp.create_dataset("value", shape=(len(named), 1), dtype=ref)
        for i, (name, value) in enumerate(named.items()):
            names[i, 0] = string(refs, f"n{i}", name)
            values[i, 0] = refs.create_dataset(f"v{i}",
                                               data=np.asarray(value).T).ref
        if meta is not None:
            m = net.create_group("meta")
            m.create_group("normalization").create_dataset(
                "averageImage", data=np.asarray(meta["averageImage"]).T)
            cell = m.create_group("classes").create_dataset(
                "name", shape=(len(meta["classes"]), 1), dtype=ref)
            for i, c in enumerate(meta["classes"]):
                cell[i, 0] = string(refs, f"c{i}", c)


def student_release(seed: int) -> dict:
    """A student release in MatConvNet's names from seeded Flax-layout
    weights, every conv and fc6 with a nonzero bias."""
    rng = np.random.RandomState(seed)
    v = random_student_variables(seed=seed, fc6=FC6, fc7=FC7)
    p, s = v["params"], v["batch_stats"]
    out = {}
    for i, conv in enumerate(("conv1", "conv2", "conv3", "conv4", "conv5",
                              "fc6"), 1):
        kernel = p[conv]["kernel"]
        name = conv if i < 6 else "fc6"
        out[f"{name}f"] = kernel
        out[f"{name}b"] = rng.normal(0, 0.3, kernel.shape[-1]).astype(np.float32)
        out[f"bn{i}f"] = p[f"bn{i}"]["scale"]
        out[f"bn{i}b"] = p[f"bn{i}"]["bias"]
        sigma = np.sqrt(s[f"bn{i}"]["var"] + matconvnet.BN_EPSILON)
        out[f"bn{i}m"] = np.stack([s[f"bn{i}"]["mean"], sigma], axis=1)
    out["fc7f"] = p["fc7"]["kernel"][None, None]
    out["fc7b"] = p["fc7"]["bias"]
    out["fc8f"] = p["prediction"]["kernel"][None, None]
    out["fc8b"] = p["prediction"]["bias"]
    return out


@pytest.fixture(scope="module", params=CONTAINERS)
def release(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("rel") / "student.mat"
    named = student_release(seed=4)
    save_mat(path, named, request.param,
             meta={"averageImage": np.arange(3, dtype=np.float32) + 0.5,
                   "classes": ["neutral", "anger"]})
    return path, named, request.param


def assert_same_tree(a, b, where=""):
    """Same keys, and leaves of the same dtype, shape and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            assert_same_tree(a[k], b[k], f"{where}/{k}")
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{where}[{i}]")
        return
    if isinstance(a, (str, int, float, type(None))):
        assert a == b, where
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, where
    assert a.tobytes() == b.tobytes(), where


def test_is_hdf5_without_h5py_agrees(tmp_path, release):
    import h5py

    path, _, container = release
    assert mat73.is_hdf5(path) == h5py.is_hdf5(str(path)) == (container == "v73")
    for name, blob in (("empty", b""), ("noise", bytes(range(256)) * 9)):
        f = tmp_path / name
        f.write_bytes(blob)
        assert mat73.is_hdf5(f) == h5py.is_hdf5(str(f)) is False, name
    for userblock in (0, 512, 2048):  # the signature at 0, 512 and 2048
        f = tmp_path / f"ub{userblock}.h5"
        with h5py.File(f, "w", userblock_size=userblock) as h:
            h["x"] = np.arange(3)
        assert mat73.is_hdf5(f) and h5py.is_hdf5(str(f)), userblock
    assert not mat73.is_hdf5(tmp_path / "missing.mat")


def test_mat73_helpers_bitwise(tmp_path):
    import h5py

    path, named = tmp_path / "student.mat", student_release(seed=2)
    save_mat(path, named, "v73")
    with h5py.File(str(path), "r") as f:
        grp = f["net"]["params"]
        assert ([f[r].name for r in mat73.cell_refs(grp["name"])]
                == [f[r].name for r in jmat73.cell_refs(grp["name"])])
        got = mat73.string_cell(f, grp["name"])
        assert list(got) == list(jmat73.string_cell(f, grp["name"])) == list(named)
        for r in mat73.cell_refs(grp["value"]):
            assert_same_tree(mat73.matlab_array(f, r), jmat73.matlab_array(f, r))


def test_importer_bitwise(release):
    path, named, _ = release
    with matconvnet.mat_cache_scope(), jmcn.mat_cache_scope():
        params = matconvnet.load_mat_params(path)
        assert_same_tree(params, jmcn.load_mat_params(path))
        assert_same_tree(matconvnet.load_mat_meta(path), jmcn.load_mat_meta(path))
        assert_same_tree(matconvnet.import_vggm_student(path),
                         jmcn.import_vggm_student(path))
    assert sorted(params) == sorted(named)
    for name, value in named.items():
        np.testing.assert_array_equal(params[name].reshape(value.shape), value)
    assert_same_tree(matconvnet.vggm_layer_map("net/"), jmcn.vggm_layer_map("net/"))


def test_helpers_bitwise():
    rng = np.random.RandomState(0)
    moments = np.stack([rng.randn(5), rng.uniform(0.001, 2, 5)], axis=1)
    gamma, beta = rng.randn(5), rng.randn(5)
    assert_same_tree(matconvnet.bn_variables(gamma, beta, moments),
                     jmcn.bn_variables(gamma, beta, moments))
    for raw, kw in ((rng.randn(7, 7, 6), {}), (rng.randn(9, 4, 6), {"squeeze_axis": 1}),
                    (rng.randn(4, 6), {"hw": (1, 1)}), (rng.randn(4, 6), {})):
        assert_same_tree(matconvnet.conv_kernel(raw, **kw),
                         jmcn.conv_kernel(raw, **kw))
    for raw in (rng.randn(1, 1, 4, 6), rng.randn(4, 6)):
        assert_same_tree(matconvnet.dense_kernel(raw), jmcn.dense_kernel(raw))


def _random_params(layer_map, rng, *, squeeze_1x1=True):
    """A release for ``layer_map`` in its first candidate names."""
    out = {}
    for spec in layer_map.values():
        first = lambda n: n if isinstance(n, str) else n[0]  # noqa: E731
        if spec["kind"] == "bn":
            c = 6
            out[first(spec["gamma"])] = rng.randn(c).astype(np.float32)
            out[first(spec["beta"])] = rng.randn(c).astype(np.float32)
            out[first(spec["moments"])] = np.stack(
                [rng.randn(c), rng.uniform(0.5, 2, c)], 1).astype(np.float32)
            continue
        if spec["kind"] == "dense":
            shape = (1, 1, 6, 5)
        elif spec.get("hw") and squeeze_1x1:
            shape = (6, 6)  # MATLAB squeezes a 1x1 filter to [Cin, Cout]
        else:
            shape = (3, 3, 6, 6)
        out[first(spec["filters"])] = rng.randn(*shape).astype(np.float32)
        out[first(spec["bias"])] = rng.randn(shape[-1]).astype(np.float32)
    return out


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("use_se", [False, True])
def test_teacher_import_bitwise(tmp_path, container, use_se):
    rng = np.random.RandomState(int(use_se))
    lm = matconvnet.resnet50_layer_map((2, 1), use_se=use_se)
    assert_same_tree(lm, jmcn.resnet50_layer_map((2, 1), use_se=use_se))
    assert_same_tree(matconvnet.senet50_layer_map(), jmcn.senet50_layer_map())
    named = _random_params(lm, rng)
    path = tmp_path / "teacher.mat"
    save_mat(path, named, container)
    with matconvnet.mat_cache_scope(), jmcn.mat_cache_scope():
        arch, tree = matconvnet.import_teacher(path)
        jarch, jtree = jmcn.import_teacher(path)
    assert arch == jarch and arch["stage_sizes"] == (2, 1)
    assert arch["use_se"] == use_se
    assert_same_tree(tree, jtree)


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("arch,release_bn,model_bn", [
    ("m", False, True), ("m", False, False), ("m", True, True),
    ("vd", False, True)])
def test_classic_teacher_import_bitwise(tmp_path, container, arch, release_bn,
                                        model_bn):
    rng = np.random.RandomState(7)
    lm = matconvnet.vggface_layer_map(arch, use_batchnorm=release_bn)
    assert_same_tree(lm, jmcn.vggface_layer_map(arch, use_batchnorm=release_bn))
    path = tmp_path / "face.mat"
    save_mat(path, _random_params(lm, rng), container)
    model = SimpleNamespace(arch=arch, use_batchnorm=model_bn)
    with matconvnet.mat_cache_scope(), jmcn.mat_cache_scope():
        assert_same_tree(matconvnet.import_classic_teacher(path, model),
                         jmcn.import_classic_teacher(path, model))


def test_a_bn_release_into_a_bn_free_model_raises_in_both(tmp_path):
    lm = matconvnet.vggface_layer_map("m", use_batchnorm=True)
    path = tmp_path / "bn.mat"
    save_mat(path, _random_params(lm, np.random.RandomState(1)), "classic")
    model = SimpleNamespace(arch="m", use_batchnorm=False)
    for mod in (matconvnet, jmcn):
        with mod.mat_cache_scope(), pytest.raises(ValueError, match="BatchNorm"):
            mod.import_classic_teacher(path, model)


def _jax_fp32(model):
    return model.clone(dtype=jnp.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_pretrained_student_logits_and_folded_means(release, seed):
    path, named, _ = release
    jmodel, jvars = jload(path, with_frontend=False)
    model, state = load_pretrained_student(path, with_frontend=False,
                                           device="cpu")
    assert model.fc6.weight.shape[0] == FC6 and model.fc7.weight.shape[0] == FC7
    for i in range(1, 7):  # mean - bias, bit for bit
        conv = f"conv{i}" if i < 6 else "fc6"
        want = np.asarray(jvars["batch_stats"][f"bn{i}"]["mean"])
        assert want.dtype == np.float32
        np.testing.assert_array_equal(state[f"bn{i}.running_mean"].numpy(), want)
        np.testing.assert_array_equal(
            want, (named[f"bn{i}m"][:, 0] - named[f"{conv}b"]).astype(np.float32))
        assert "bias" not in jvars["params"][conv]
    assert_same_tree({k: v.numpy() for k, v in state.items()},
                     {k: v.numpy() for k, v in
                      student_state_dict_from_flax(jvars).items()})
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    model = VGGMStudent(fc6_features=FC6, fc7_features=FC7, dtype=torch.float32)
    model.load_state_dict(state)

    x = np.random.RandomState(seed).randn(2, 512, 100, 1).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(_jax_fp32(jmodel).apply(jvars, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), train=False).numpy()
    scale = np.abs(ref).max()
    assert scale > 0.1 and got.shape == ref.shape == (2, 8)
    assert np.abs(got - ref).max() <= 1e-4 * scale


def test_pretrained_pipeline_from_waveforms(release):
    path, _, _ = release
    jmodel, jvars = jload(path, with_frontend=False)
    _, state = load_pretrained_student(path, with_frontend=True, device="cpu")
    assert all(k.startswith("net.") for k in state)
    pipe = AudioStudentPipeline(fc6_features=FC6, fc7_features=FC7,
                                dtype=torch.float32)
    pipe.load_state_dict(state)
    wav = (np.random.RandomState(3).randn(2, 16384) * 0.1).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(_jax_fp32(jmodel).apply(
            jvars, jwaveform_to_input(jnp.asarray(wav))))
    with torch.inference_mode():
        got = pipe(torch.from_numpy(wav), train=False).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_pretrained_student_takes_a_path_only(tmp_path):
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        load_pretrained_student("emovoxceleb-student", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        load_pretrained_student(tmp_path / "x.mat")
