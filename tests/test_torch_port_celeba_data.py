"""The port's CelebA dataset and pixel transforms against the JAX package's,
on the CPU.

get_predefined_dataset("celeba") on a written celeba_64.npy and
list_attr_celeba.txt (CelebA's format: a count line, the 40 names, then one
file name and 40 values per image, two spaces before a 1): images and attrs
byte for byte (the port parses the file with numpy, the JAX package with
pandas). load_celeba on the procedural fallback: byte for byte.
data/transform.py: resize_center_crop on uint8 NHWC and NHW images (a
218 x 178 -> 64 shrink as CelebA's crop, an enlargement, the identity size)
within one LSB, on at most 1e-3 of the pixels (the JAX package's eager
jax.image.resize and the port's matrices round differently in float32: 9
of 786,432 pixels moved on the 64 CelebA-sized images, 2 of 24,576 on the 6
gray ones); grayscale_to_rgb and remove_outliers exactly.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from diagan_tpu.data import predefined as JP  # noqa: E402
from diagan_tpu.data import sources as JS  # noqa: E402
from diagan_tpu.data import transform as JT  # noqa: E402
from diagan_tpu_torch.data import predefined as TP  # noqa: E402
from diagan_tpu_torch.data import sources as TS  # noqa: E402
from diagan_tpu_torch.data import transform as TT  # noqa: E402


def write_celeba(root, images, attrs):
    """celeba_64.npy and list_attr_celeba.txt in CelebA's layout."""
    root.mkdir(parents=True, exist_ok=True)
    np.save(root / "celeba_64.npy", images)
    lines = [str(len(images)), " ".join(TS.CELEBA_ATTR_NAMES) + " "]
    for i, row in enumerate(attrs):
        lines.append(f"{i + 1:06d}.jpg " + " ".join(f"{int(a):2d}" for a in row))
    (root / "list_attr_celeba.txt").write_text("\n".join(lines) + "\n")
    return root


def test_get_predefined_dataset_celeba_equals_the_jax_package(tmp_path):
    images = np.random.default_rng(0).integers(0, 256, (24, 64, 64, 3)).astype(np.uint8)
    root = write_celeba(tmp_path / "celeba", images, TS.synthetic_celeba_attrs(images, seed=2))
    want, got = JP.get_predefined_dataset("celeba", root), TP.get_predefined_dataset("celeba", root)
    assert got.name == want.name == "celeba" and len(got) == 24
    for field in ("images", "targets", "labels", "weights", "attrs"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), field
    assert set(np.unique(got.attrs)) == {-1, 1}
    for n in (5, 24, 30):  # fewer, as many and more rows than asked for
        attr_file = root / "list_attr_celeba.txt"
        assert TS.load_celeba_attrs(attr_file, n).tobytes() == JS.load_celeba_attrs(attr_file,
                                                                                   n).tobytes()


def test_load_celeba_fallback_equals_the_jax_package(tmp_path):
    want = JS.load_celeba(tmp_path / "absent", size=64, fallback_n=16)
    got = TS.load_celeba(tmp_path / "absent", size=64, fallback_n=16)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert got[0].shape == (16, 64, 64, 3) and got[1].shape == (16, 40)


@pytest.mark.parametrize("shape,size", [
    ((64, 218, 178, 3), 64),  # CelebA's aligned crops to 64 px
    ((6, 218, 178), 64),      # grayscale NHW
    ((8, 20, 24, 3), 40),     # an enlargement
    ((4, 30, 17), 23),        # a shrink of the short side, NHW
    ((4, 64, 64, 3), 64),     # the identity size
], ids=["celeba_shrink", "gray_shrink", "enlarge", "gray_odd", "identity"])
def test_resize_center_crop_against_the_jax_package(shape, size):
    x = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    want, got = JT.resize_center_crop(x, size), TT.resize_center_crop(x, size)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.shape == shape[:1] + (size, size) + shape[3:]
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def test_grayscale_to_rgb_and_remove_outliers_equal_the_jax_package():
    rng = np.random.default_rng(2)
    for x in (rng.integers(0, 256, (3, 8, 8)).astype(np.uint8),
              rng.integers(0, 256, (3, 8, 8, 1)).astype(np.uint8),
              rng.integers(0, 256, (3, 8, 8, 3)).astype(np.uint8)):
        assert np.array_equal(TT.grayscale_to_rgb(x), JT.grayscale_to_rgb(x))
    x = rng.integers(100, 120, (50, 4, 4, 3)).astype(np.uint8)
    x[7] = 255
    got = TT.remove_outliers(x)
    assert np.array_equal(got, JT.remove_outliers(x)) and len(got) == 49
