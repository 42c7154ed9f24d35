"""The port's Colored-MNIST, MNIST-FMNIST and 25-Gaussians data against the
JAX package's, on the CPU.

MNIST and FashionMNIST come from small idx-ubyte files written here (the
procedural digits and items of data/synthetic.py, in MNIST's format), so
both packages read the same files. Each build (the same seed for the numpy
draws) must equal the JAX package's byte for byte: images after the 28 ->
32 resize, targets, bias / mixed labels, weights. Each package must load the
cache the other wrote (the pickles are the same bytes). The 25-Gaussians
points and labels are the same float32 / int64 arrays, and the port's
DeviceDataSource gathers them as they are, as the JAX one does (no
dequantize), and dequantizes uint8 images as before.
"""
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diagan_tpu.data import pipeline as JP  # noqa: E402
from diagan_tpu.data import predefined as JPD  # noqa: E402
from diagan_tpu_torch.data import predefined as TPD  # noqa: E402
from diagan_tpu_torch.data.arrays import ArrayDataset  # noqa: E402
from diagan_tpu_torch.data.gaussian import GaussianDataset  # noqa: E402
from diagan_tpu_torch.data import synthetic as TSYN  # noqa: E402
from diagan_tpu_torch.data.pipeline import DeviceDataSource  # noqa: E402

N_DIGITS = 120


def write_idx(path, arr):
    """An idx-ubyte file (MNIST's format) holding the uint8 array `arr`."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def write_mnist(root, fmnist_root=None, n=N_DIGITS):
    """train-images/labels idx files of the procedural digits under root, and
    of the procedural FashionMNIST items under fmnist_root."""
    for where, make in ((root, TSYN.synthetic_mnist), (fmnist_root, TSYN.synthetic_fmnist)):
        if where is None:
            continue
        where.mkdir(parents=True, exist_ok=True)
        images, targets = make(n)
        write_idx(where / "train-images-idx3-ubyte", images)
        write_idx(where / "train-labels-idx1-ubyte", targets)
    return root


def same_dataset(got, want):
    assert got.name == want.name and len(got) == len(want)
    for field in ("images", "targets", "labels", "weights"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), field


CASES = {  # name: (build kwargs, cache directory, cache files)
    "color_mnist": (dict(major_ratio=0.9, num_data=100, seed=3), "color_mnist-rd0.9-n100",
                    ("data", "targets", "biased_targets")),
    "mnist_fmnist": (dict(major_ratio=0.8, num_data=90, seed=4), "mnist_fmnist-0.8-n90",
                     ("data", "targets", "mixed_targets")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mnist_families_match_jax_and_share_caches(name, tmp_path):
    kwargs, cache, files = CASES[name]
    fm = name == "mnist_fmnist"
    for who in ("jax", "port"):  # one root each, so that each package builds its own cache
        write_mnist(tmp_path / who, fmnist_root=(tmp_path / who / "fmnist") if fm else None)
    extra = {"fmnist_root": str(tmp_path / "jax" / "fmnist")} if fm else {}
    want = JPD.get_predefined_dataset(name, tmp_path / "jax", **kwargs, **extra)
    extra = {"fmnist_root": str(tmp_path / "port" / "fmnist")} if fm else {}
    got = TPD.get_predefined_dataset(name, tmp_path / "port", **kwargs, **extra)
    same_dataset(got, want)
    assert got.images.shape == (kwargs["num_data"], 32, 32, 1 if fm else 3)
    minority = int(round(kwargs["num_data"] * (1 - kwargs["major_ratio"])))
    assert int(got.labels.sum()) == minority
    if not fm:  # red majority, green minority, nothing else
        colours = got.images.reshape(-1, 3)[got.images.reshape(-1, 3).any(1)]
        assert (colours[:, 2] == 0).all()
        lit = got.images.reshape(len(got), -1, 3).max(1)
        assert ((lit[:, 1] > 0) == (got.labels == 1)).all()
    for f in files:  # the two caches hold the same bytes
        a = (tmp_path / "jax" / cache / f"{f}.pkl").read_bytes()
        assert a == (tmp_path / "port" / cache / f"{f}.pkl").read_bytes(), f

    # each package loads the other's cache: swap the two cache directories
    (tmp_path / "jax" / cache).rename(tmp_path / "tmp")
    (tmp_path / "port" / cache).rename(tmp_path / "jax" / cache)
    (tmp_path / "tmp").rename(tmp_path / "port" / cache)
    same_dataset(TPD.get_predefined_dataset(name, tmp_path / "port", **kwargs), want)
    same_dataset(JPD.get_predefined_dataset(name, tmp_path / "jax", **kwargs), want)


def test_25gaussian_matches_jax_and_gathers_points_as_they_are():
    want = JPD.get_predefined_dataset("25gaussian", None, n_samples=250, seed=5)
    got = TPD.get_predefined_dataset("25gaussian", None, n_samples=250, seed=5)
    same_dataset(got, want)
    assert got.images.dtype == np.float32 and got.images.shape == (250, 2)
    assert sorted(np.bincount(got.targets)) == [10] * 25
    default = TPD.get_predefined_dataset("25gaussian", "unused")
    same_dataset(default, JPD.get_predefined_dataset("25gaussian", "unused"))
    assert len(default) == 10000

    idx = np.array([3, 0, 249, 17])
    jsrc, tsrc = JP.DeviceDataSource(want), DeviceDataSource(got, device="cpu")
    assert not jsrc._quantized and not tsrc.quantized
    g = tsrc.gather(torch.from_numpy(idx))
    assert g.dtype == torch.float32
    assert g.numpy().tobytes() == np.asarray(jsrc.gather(idx)).tobytes()
    # uint8 images still dequantize: (x / 127.5 - 1) in fp32, as before
    imgs = TSYN.synthetic_natural(6, 8, seed=1)[0]
    src = DeviceDataSource(ArrayDataset.from_images(imgs), device="cpu")
    assert src.quantized
    np.testing.assert_array_equal(src.gather(torch.arange(6)).numpy(),
                                  imgs.astype(np.float32) / 127.5 - 1.0)
    wide = GaussianDataset(images=np.zeros((3, 2)), targets=np.zeros(3, np.int64),
                           labels=np.zeros(3, np.int64), weights=np.ones(3))
    with pytest.raises(ValueError, match="uint8 images or float32 points"):
        DeviceDataSource(wide, device="cpu")  # float64 points
