"""Port DRS, quantization, PNG grids, checkpoint and the generate CLI.

DRS decisions are held exactly against the JAX package's DRS on the same
logits and uniforms (injected), including the compaction of one proposal
batch. The PNG writer is held pixel for pixel against the JAX package's
PIL-based save_image_grid. Everything runs on the CPU at a small size.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from diagan_tpu.eval import drs as jdrs  # noqa: E402
from diagan_tpu.train import logger as jlogger  # noqa: E402
from diagan_tpu_torch.cli import generate  # noqa: E402
from diagan_tpu_torch.eval import drs as tdrs  # noqa: E402
from diagan_tpu_torch.eval import evaluate as tev  # noqa: E402
from diagan_tpu_torch.models.stylegan2 import (  # noqa: E402
    StyleGAN2Discriminator,
    StyleGAN2Generator,
)
from diagan_tpu_torch.train import logger as tlogger  # noqa: E402

NZ = 48


def _port_drs(**kw):
    return tdrs.DRS(lambda z: z, lambda x: x, NZ, warmup_batches=0, device="cpu", **kw)


@pytest.mark.parametrize("seed,gamma,above", [(0, None, False), (1, None, True),
                                              (2, 0.5, False), (3, None, False)])
def test_drs_accept_mask_matches_jax(seed, gamma, above):
    """The device accept test and the host one of the JAX DRS give the same
    mask as the port, bit for bit, with the running max updated first."""
    rng = np.random.default_rng(seed)
    ldr = (2.0 * rng.standard_normal(256)).astype(np.float32)
    u = rng.uniform(size=256).astype(np.float32)
    prev_max = np.float32(ldr.max() + 1.0 if above else ldr.max() - 1.0)
    m = np.float32(max(prev_max, ldr.max()))
    jself = SimpleNamespace(percentile=80, gamma=gamma, maximum=float(prev_max))
    want_dev = np.asarray(jdrs.DRS._accept_device(jself, jnp.asarray(ldr), jnp.asarray(u), m))
    want_host = jdrs.DRS._accept(jself, ldr, u)
    port = _port_drs(gamma=gamma)
    got = port._accept_device(torch.from_numpy(ldr), torch.from_numpy(u),
                              torch.tensor(m)).numpy()
    np.testing.assert_array_equal(got, want_dev)
    np.testing.assert_array_equal(got, want_host)
    assert 0 < got.sum() < len(got)


def test_drs_batch_compaction_matches_jax():
    """One JAX proposal chunk (chunk=1) against the port's per-batch
    max-update, accept and stable compaction on the same images, logits and
    uniforms; the JAX draws are rebuilt from its keys as its scan splits them."""
    batch = 64

    def gen_fn(z):
        return jnp.tanh(z.reshape(-1, 4, 4, 3))

    def disc_fn(x):
        return 4.0 * x.mean(axis=(1, 2, 3))

    jd = jdrs.DRS(gen_fn, disc_fn, NZ, key=jax.random.key(3), batch_size=batch, chunk=1)
    key = jax.random.key(7)
    prev_max = jnp.float32(jd.maximum)
    packed, n_acc, m = jd._propose_accept_chunk(key, prev_max)
    kz, ku = jax.random.split(jax.random.split(key, 1)[0])
    imgs = gen_fn(jax.random.normal(kz, (batch, NZ)))
    ldr = disc_fn(imgs)
    u = jax.random.uniform(ku, (batch,))

    port = _port_drs(batch_size=batch)
    got, got_n, got_m = port._accept_compact(
        *(torch.tensor(np.asarray(a)) for a in (imgs, ldr, u, prev_max)))
    k = int(n_acc)
    assert int(got_n) == k and 0 < k < batch
    assert float(got_m) == float(m)
    np.testing.assert_array_equal(got.numpy()[:k], np.asarray(packed)[:k])


def test_quantization_matches_jax():
    rng = np.random.default_rng(5)
    x = np.clip(1.1 * rng.standard_normal((6, 8, 8, 3)), -1.3, 1.3).astype(np.float32)
    np.testing.assert_array_equal(tdrs.minmax_uint8(torch.from_numpy(x)).numpy(),
                                  np.asarray(jdrs.minmax_uint8(jnp.asarray(x))))
    want = np.asarray(jnp.clip((jnp.asarray(x) + 1) * 127.5, 0, 255).astype(jnp.uint8))
    np.testing.assert_array_equal(tdrs.to_uint8(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(tlogger.to_uint8(x), jlogger.to_uint8(x))


@pytest.mark.parametrize("n,c,nrow", [(5, 3, 2), (3, 1, 8), (1, 3, 1)])
def test_png_grid_matches_jax_pixel_for_pixel(tmp_path, n, c, nrow):
    rng = np.random.default_rng(n * 10 + c)
    imgs = rng.uniform(-1.2, 1.2, size=(n, 7, 9, c)).astype(np.float32)
    jlogger.save_image_grid(imgs, tmp_path / "jax.png", nrow=nrow)
    tlogger.save_image_grid(imgs, tmp_path / "port.png", nrow=nrow)
    with Image.open(tmp_path / "jax.png") as a, Image.open(tmp_path / "port.png") as b:
        assert a.mode == b.mode
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _tiny_models(seed):
    torch.manual_seed(seed)
    g = StyleGAN2Generator(size=16, style_dim=32, n_mlp=2, width_scale=1 / 16, device="cpu")
    d = StyleGAN2Discriminator(size=16, width_scale=1 / 16, device="cpu")
    return g, d


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_checkpoint_round_trip_and_drs_fallback(tmp_path):
    g, d = _tiny_models(0)
    _, drs_d = _tiny_models(1)
    path = tev.save_stylegan2_ckpt(tmp_path / "full.pt", g, d, drs_d)
    g2, d2 = _tiny_models(2)
    tev.read_stylegan2_ckpt(path, g2, d2, use_drs=True)
    assert _same_state(g2, g) and _same_state(d2, drs_d)
    # without a drs_d entry, DRS reads d
    path = tev.save_stylegan2_ckpt(tmp_path / "no_drs.pt", g, d)
    g3, d3 = _tiny_models(3)
    tev.read_stylegan2_ckpt(path, g3, d3, use_drs=True)
    assert _same_state(d3, d)


def test_drs_and_sampler_end_to_end_on_cpu():
    g, d = _tiny_models(0)
    gen_fn = tev.make_gen_fn(g, generator=torch.Generator().manual_seed(1))
    disc_fn = tev.make_disc_fn(d)
    drs = tdrs.DRS(gen_fn, disc_fn, 32, generator=torch.Generator().manual_seed(2),
                   batch_size=16, warmup_batches=2, device="cpu")
    assert drs.maximum > -1e5
    imgs = drs.generate_images(20)
    assert imgs.shape == (20, 16, 16, 3) and np.isfinite(imgs).all()
    assert 0 < drs.accepted < drs.proposed
    u8 = drs.generate_images(4, minmax_uint8=True)
    assert u8.dtype == np.uint8 and u8.shape == (4, 16, 16, 3)
    sampler = tev.Sampler(gen_fn, 32, batch_size=8, device="cpu")
    s = sampler.generate_images(10, return_uint8=True)
    assert s.dtype == np.uint8 and s.shape == (10, 16, 16, 3)


def test_generate_cli_on_cpu(tmp_path):
    torch.manual_seed(0)
    g = StyleGAN2Generator(size=16, device="cpu")
    ckpt = tev.save_stylegan2_ckpt(tmp_path / "ckpt.pt", g)
    argv = ["--size", "16", "--sample", "4", "--pics", "2", "--truncation", "0.7",
            "--truncation_mean", "64", "--ckpt", str(ckpt), "--device", "cpu"]
    a = generate.main(argv + ["--out_dir", str(tmp_path / "a")])
    b = generate.main(argv + ["--out_dir", str(tmp_path / "b")])
    assert a.shape == (8, 16, 16, 3) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)  # same seed, same samples
    for i in range(2):
        with Image.open(tmp_path / "a" / f"{i:06d}.png") as im:
            assert im.size == (2 * 18 + 2, 2 * 18 + 2)
            np.testing.assert_array_equal(
                np.asarray(im)[2:18, 2:18], tlogger.to_uint8(a[4 * i]))
