"""The port's modules that have no caller in either package's training path
against the JAX package: eval/lpips.py (with utils/jax_params.py
lpips_state_dict and cli/validate_weights.py), ModulatedConv's downsample
(models/stylegan2.py), data/index_loader.py, utils/cond.py,
utils/trainer.py, and data/sources.py load_celeba's img_align_celeba/
branch.

- LPIPS without heads, with heads (one lpips-layout head file read by both
  packages' _load_lins), and with a torchvision-layout VGG16 file read by
  both packages' _load_vgg: the jitted JAX LPIPS at 1e-5 relative, d(x, x)
  = 0; validate_weights' stages on random pytorch-fid / torchvision / lpips
  files on the CPU;
- ModulatedConv(downsample=True) at k = 3 and 1, with the JAX package's
  blur fold on (DIAGAN_TPU_FOLD_BLUR=1) and off, at 1e-5 x max(1,
  max|out|);
- the by-index loaders on PNG directories written here, on an npy cache and
  on the synthetic fallbacks: byte for byte, and the < 1000 guard;
- cond and utils/trainer: exact;
- load_celeba on an img_align_celeba/ directory of JPEGs: byte for byte,
  the cache it writes too.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402
from test_torch_port_generator import _randomize_zero_init  # noqa: E402

from diagan_tpu.data import index_loader as JIL  # noqa: E402
from diagan_tpu.data import sources as JSRC  # noqa: E402
from diagan_tpu.eval import lpips as JLP  # noqa: E402
from diagan_tpu.models import stylegan2 as JSG  # noqa: E402
from diagan_tpu.utils import cond as JCOND  # noqa: E402
from diagan_tpu.utils import trainer as JUT  # noqa: E402
from diagan_tpu_torch.cli import validate_weights  # noqa: E402
from diagan_tpu_torch.data import index_loader as TIL  # noqa: E402
from diagan_tpu_torch.data import sources as TSRC  # noqa: E402
from diagan_tpu_torch.eval import inception  # noqa: E402
from diagan_tpu_torch.eval import lpips as TLP  # noqa: E402
from diagan_tpu_torch.eval.inception import InceptionV3, random_init_  # noqa: E402
from diagan_tpu_torch.eval.metrics import activation_statistics  # noqa: E402
from diagan_tpu_torch.models import stylegan2 as TSG  # noqa: E402
from diagan_tpu_torch.ops.upfirdn2d import fir_instance  # noqa: E402
from diagan_tpu_torch.utils import cond as TCOND  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402
from diagan_tpu_torch.utils import trainer as TUT  # noqa: E402

VGG_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)  # torchvision's features.{i}
VGG_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_bytes(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


# --- LPIPS ------------------------------------------------------------------

def write_vgg(path, seed):
    """A random VGG16 state_dict in torchvision's layout, classifier
    included (small: only its order and rank matter to the loaders)."""
    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for i, cout in zip(VGG_CONVS, VGG_WIDTHS):
        sd[f"features.{i}.weight"] = torch.randn((cout, cin, 3, 3), generator=g) / (3 * cin) ** 0.5
        sd[f"features.{i}.bias"] = 0.1 * torch.randn(cout, generator=g)
        cin = cout
    for i in (0, 3, 6):
        sd[f"classifier.{i}.weight"] = torch.randn((4, 4), generator=g)
        sd[f"classifier.{i}.bias"] = torch.randn(4, generator=g)
    torch.save(sd, path)
    return path


def write_lins(path, seed):
    """Random lpips heads, lin{i}.model.1.weight of shape (1, C, 1, 1)."""
    g = torch.Generator().manual_seed(seed)
    torch.save({f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=g)
                for i, c in enumerate((64, 128, 256, 512, 512))}, path)
    return path


@pytest.fixture
def jax_lpips(monkeypatch):
    """The JAX LPIPS class with its VGG init replaced by seeded numpy in
    init's shapes (jax.eval_shape; an eager init costs ~6 s here). Its
    distance is jitted with the heads it has at the first call, so each
    setting of heads takes its own instance."""
    net = JLP._VGGFeatures()
    shapes = jax.eval_shape(lambda: net.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1])))\
                .astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    monkeypatch.setattr(JLP._VGGFeatures, "init",
                        lambda self, *a, **k: jax.tree.map(np.array, variables))
    return JLP.LPIPS


def lpips_inputs(seed, n=2, size=32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32) for _ in range(2)]


def rel_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=0, err_msg=what)


def test_lpips_through_the_bridge_with_and_without_heads(jax_lpips, tmp_path):
    plain = jax_lpips()
    port = TLP.LPIPS(device="cpu")
    assert port.weights_kind == plain.weights_kind == "random"
    port.load_state_dict(jax_params.lpips_state_dict(jax.device_get(plain.variables)))
    x, y = lpips_inputs(0)
    rel_close(port(x, y), plain(x, y), "no heads")
    lins = write_lins(tmp_path / "lin.pth", 1)
    port._load_lins(lins)
    want = np.asarray(jax_lpips(lin_path=str(lins))(x, y))
    rel_close(port(x, y), want, "heads")
    assert np.abs(want - np.asarray(plain(x, y))).max() > 1e-3  # the heads matter
    # NCHW tensors give the same distances; d(x, x) = 0
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y).permute(0, 3, 1, 2))
    rel_close(got.numpy(), want, "NCHW")
    assert np.all(port(x, x) == 0)


def test_lpips_loads_a_torchvision_vgg_file_as_the_jax_package(jax_lpips, tmp_path):
    vgg = write_vgg(tmp_path / "vgg.pth", 2)
    want_lp = jax_lpips(weights_path=str(vgg))
    port = TLP.LPIPS(weights_path=vgg, device="cpu")
    assert port.weights_kind == want_lp.weights_kind == "loaded"
    x, y = lpips_inputs(3, size=48)
    rel_close(port(x, y), want_lp(x, y), "loaded VGG")
    bad = torch.load(vgg)
    bad["features.0.weight"] = bad["features.0.weight"][:, :2]
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="VGG conv 0"):
        TLP.LPIPS(weights_path=tmp_path / "bad.pth", device="cpu")


def test_lpips_bridge_raises_on_an_unknown_leaf(jax_lpips):
    params = dict(jax.device_get(jax_lpips().variables)["params"])
    params["Dense_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="Dense_0/kernel"):
        jax_params.lpips_state_dict({"params": params})


def test_validate_weights_passes_on_random_files(tmp_path, capsys, monkeypatch):
    """Every stage on the CPU, with seeded random files in pytorch-fid's,
    torchvision's and lpips' layouts (the Inception's strict load, its smoke
    FID; the LPIPS converter and distance sanity); a file with a key the
    port does not have fails the strict load, and a file of another network
    fails the LPIPS stage."""
    monkeypatch.setattr(inception, "INCEPTION_SIZE", 75)  # the smallest input; 299 is slow here
    # the smoke FID's statistics over the first 256 of the 2048 dims: scipy's sqrtm of a
    # 2048-d covariance costs ~10 s here, and the distance itself is tested elsewhere
    monkeypatch.setattr(validate_weights, "activation_statistics",
                        lambda f: activation_statistics(f[:, :256]))
    model = random_init_(InceptionV3(device="cpu"), seed=0)
    sd = model.state_dict()
    torch.save(sd, tmp_path / "fid.pth")
    vgg, lins = write_vgg(tmp_path / "vgg.pth", 4), write_lins(tmp_path / "lin.pth", 5)
    argv = ["--inception", str(tmp_path / "fid.pth"), "--lpips_vgg", str(vgg),
            "--lpips_lin", str(lins), "--device", "cpu"]
    assert validate_weights.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("PASS  ") == 4 and "FAIL" not in out and "ALL PASS" in out
    sd["Mixed_7c.branch_pool.extra"] = torch.zeros(3)
    torch.save(sd, tmp_path / "extra.pth")
    with pytest.raises(ValueError, match="Mixed_7c.branch_pool.extra"):
        validate_weights.strict_inception(tmp_path / "extra.pth")
    results = []
    validate_weights.validate_lpips(str(tmp_path / "extra.pth"), None, torch.device("cpu"),
                                    results)
    assert results == [("lpips: converter + distance sanity", False)]
    assert "FAIL  lpips" in capsys.readouterr().out


# --- ModulatedConv(downsample=True) ----------------------------------------

@pytest.mark.parametrize("fold", ["1", "0"], ids=["fold", "unfolded"])
@pytest.mark.parametrize("kernel_size", [3, 1])
def test_modulated_conv_downsample_matches_jax(kernel_size, fold, monkeypatch):
    monkeypatch.setenv("DIAGAN_TPU_FOLD_BLUR", fold)
    rng = np.random.default_rng(kernel_size)
    n, cin, cout, s, h = 2, 8, 6, 16, 16
    mod = JSG.ModulatedConv(features=cout, kernel_size=kernel_size, downsample=True)
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    style = rng.standard_normal((n, s)).astype(np.float32)
    shapes = jax.eval_shape(lambda: mod.init(jax.random.key(0), jnp.asarray(x),
                                             jnp.asarray(style)))["params"]
    params = _randomize_zero_init(jax.tree.map(
        lambda l: rng.standard_normal(l.shape).astype(np.float32), shapes), 4)
    want = np.asarray(jax.jit(lambda p, x, s: mod.apply({"params": p}, x, s))(params, x, style))
    port = TSG.ModulatedConv(cin, cout, s, kernel_size, downsample=True, device="cpu")
    port.load_state_dict(jax_params.modulated_conv_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(style))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (n, h // 2, h // 2, cout)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    # the blur is kernel A's fir4x4 instance on the card
    assert port.blur.pad == ((kernel_size + 2) // 2, (kernel_size + 1) // 2)
    assert fir_instance(4, 4, 1, 1, torch.float32, torch.contiguous_format) == "fir4x4"


# --- the by-index loaders ---------------------------------------------------

def write_png(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def test_index_images_of_arrays_and_sequences():
    data = np.random.default_rng(0).integers(0, 256, (10, 4, 4, 3), dtype=np.uint8)
    index = [3, 1, 3, 9]
    same_bytes(TIL.get_index_images(data, index), JIL.get_index_images(data, index))
    seq = [(img, i) for i, img in enumerate(data)]
    same_bytes(TIL.get_index_images(seq, index), JIL.get_index_images(seq, index))
    same_bytes(TIL.get_index_images(list(data), index), data[index])


def test_imagenet_loader_reads_class_directories_and_guards(tmp_path):
    rng = np.random.default_rng(1)
    for c in ("n01", "n02"):
        for f in range(3):
            write_png(tmp_path / "imagenet" / "train" / c / f"{f}.png",
                      rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    index = np.arange(1000) % 3
    got = TIL.get_imagenet_images_with_index(index, root=tmp_path, size=8)
    same_bytes(got, JIL.get_imagenet_images_with_index(index, root=tmp_path, size=8))
    assert got.shape == (2000, 8, 8, 3)
    same_bytes(TIL.get_imagenet_images_with_index(index, root=tmp_path / "absent", size=8),
               JIL.get_imagenet_images_with_index(index, root=tmp_path / "absent", size=8))
    for loader in (TIL.get_imagenet_images_with_index, JIL.get_imagenet_images_with_index):
        with pytest.raises(ValueError, match="at least 1000"):
            loader(np.arange(999), root=tmp_path)


def test_lsun_loader_reads_files_a_cache_and_the_fallback(tmp_path):
    rng = np.random.default_rng(2)
    base = tmp_path / "lsun" / "bedroom_train"
    write_png(base / "a.png", rng.integers(0, 256, (20, 24, 3), dtype=np.uint8))
    write_png(base / "b.png", rng.integers(0, 256, (18, 18), dtype=np.uint8))  # grayscale
    write_png(base / "c.png", rng.integers(0, 256, (16, 22, 4), dtype=np.uint8))  # RGBA
    (base / "notes.txt").write_text("not an image")
    index = [2, 0, 1, 1]
    got = TIL.get_lsun_bedroom_images_with_index(index, root=tmp_path, size=12)
    same_bytes(got, JIL.get_lsun_bedroom_images_with_index(index, root=tmp_path, size=12))
    assert got.shape == (4, 12, 12, 3)
    np.save(tmp_path / "lsun" / "lsun_bedroom_12.npy", got[::-1].copy())
    same_bytes(TIL.get_lsun_bedroom_images_with_index(index, root=tmp_path, size=12),
               JIL.get_lsun_bedroom_images_with_index(index, root=tmp_path, size=12))
    same_bytes(TIL.get_lsun_bedroom_images_with_index(index, root=tmp_path / "no", size=16),
               JIL.get_lsun_bedroom_images_with_index(index, root=tmp_path / "no", size=16))


def test_celeba_loader_reads_the_cache_and_the_fallback(tmp_path):
    images = np.random.default_rng(3).integers(0, 256, (12, 16, 16, 3), dtype=np.uint8)
    (tmp_path / "celeba").mkdir()
    np.save(tmp_path / "celeba" / "celeba_16.npy", images)
    index = np.array([11, 0, 5, 5])
    got = TIL.get_celeba_images_with_index(index, root=tmp_path, size=16)
    same_bytes(got, JIL.get_celeba_images_with_index(index, root=tmp_path, size=16))
    same_bytes(got, images[index])
    same_bytes(TIL.get_celeba_images_with_index(index, root=tmp_path / "no", size=16),
               JIL.get_celeba_images_with_index(index, root=tmp_path / "no", size=16))


def test_load_celeba_reads_an_image_directory(tmp_path):
    """The img_align_celeba/ branch: Resize(size) of the short side, then a
    center crop; the cache it writes; the attributes beside it."""
    rng = np.random.default_rng(4)
    src = tmp_path / "src" / "img_align_celeba"
    src.mkdir(parents=True)
    for i, (h, w) in enumerate(((218, 178), (40, 60), (33, 33), (20, 50))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            src / f"{i + 1:06d}.jpg", quality=90)
    (src / "readme.txt").write_text("not a jpg")
    roots = {}
    for name in ("jax", "port"):
        roots[name] = tmp_path / name
        shutil.copytree(tmp_path / "src", roots[name])
    want = JSRC.load_celeba(roots["jax"], size=24)
    got = TSRC.load_celeba(roots["port"], size=24)
    for w, g in zip(want, got):
        same_bytes(g, w)
    assert got[0].shape == (4, 24, 24, 3)
    same_bytes(np.load(roots["port"] / "celeba_24.npy"), np.load(roots["jax"] / "celeba_24.npy"))


# --- cond and utils/trainer -------------------------------------------------

@pytest.mark.parametrize("scores", [
    np.concatenate([np.random.default_rng(5).normal(-2, 0.5, 300),
                    np.random.default_rng(6).normal(1.5, 0.8, 120)]),
    np.random.default_rng(7).uniform(0, 1, 50),
    np.full(10, 3.0),
], ids=["bimodal", "uniform", "constant"])
def test_otsu_split_is_the_jax_packages(scores):
    assert TCOND.otsu_threshold(scores) == JCOND.otsu_threshold(scores)
    for got, want in zip(TCOND.get_index_group(scores), JCOND.get_index_group(scores)):
        same_bytes(got, want)


def test_trainer_utilities_are_the_jax_packages(tmp_path):
    got, want = TUT.AverageMeter(), JUT.AverageMeter()
    for val, n in ((0.5, 4), (1.25, 2), (3.0, 1)):
        got.update(val, n)
        want.update(val, n)
    assert vars(got) == vars(want)
    got.reset()
    assert got.count == 0 and got.avg == 0.0
    rng = np.random.default_rng(8)
    logits, target = rng.standard_normal((40, 10)), rng.integers(0, 10, 40)
    assert TUT.accuracy(logits, target, topk=(1, 3, 5)) == JUT.accuracy(logits, target,
                                                                        topk=(1, 3, 5))
    assert TUT.accuracy(torch.from_numpy(logits), torch.from_numpy(target)) == JUT.accuracy(
        logits, target)
    TUT.save_np_arr([[1, 2], [3, 4]], tmp_path / "a.npy")
    JUT.save_np_arr([[1, 2], [3, 4]], tmp_path / "b.npy")
    same_bytes(np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy"))
