"""The FFHQ trainer's last flags in the port (diagan_tpu_torch): --bf16,
--remat, --stream_data with the native host loader, --no_fuse and
--max_chunk, and prepare_data; against the JAX package where it has a
counterpart.

- native/: the port's own build of diagan_io.cpp against the JAX package's,
  same weights and seed: identical alias-sampler draws, gathered bytes,
  normalised floats and single-thread loader batches; a failed build raises.
- stream mode: the trainer's real-index stream over two steps (the first an
  R1 step) against the JAX trainer's `_host_stacks(start, 1)`: identical;
  the streamed logit sweep against the device-resident one: bit for bit.
- bf16: D (logits, features) and G against the JAX package's bf16 modules
  on the same weights, within 5e-2 x max(1, max|.|) (measured on the CPU:
  D logits 3.3e-3, features 5.9e-3, G images 8.9e-3 of that scale; the JAX
  bf16 modules' own distance from their fp32: 2.3e-3, 7.4e-3, 1.0e-2).
- remat: the same state_dict keys, and the same losses and gradients, bit
  for bit on the CPU, for the D, R1, G and path steps, fp32 and bf16.
- --no_fuse / --max_chunk 1 against neither: the same losses over two steps,
  bit for bit; the CLIs with every flag through phase 1 and phase 2.
- prepare_npy and cli.prepare_data against the JAX package and
  stylegan2/prepare_data.py: the same bytes and the same argparse surface.

Small models: 16 px, width 1/16, style_dim 32, n_mlp 2, batch 4. Flax
variables come from jax.eval_shape filled with seeded numpy.
"""
import functools
import math
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diagan_tpu.data import ffhq as JF  # noqa: E402
from diagan_tpu.models import stylegan2 as J  # noqa: E402
from diagan_tpu.native import io as JN  # noqa: E402
from diagan_tpu.train import stylegan2_trainer as JT  # noqa: E402
from diagan_tpu_torch.cli import prepare_data, train_ffhq, train_ffhq_phase2  # noqa: E402
from diagan_tpu_torch.data import ffhq as TF  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.models import stylegan2 as T  # noqa: E402
from diagan_tpu_torch.models.ada import sample_augment  # noqa: E402
from diagan_tpu_torch.native import io as TN  # noqa: E402
from diagan_tpu_torch.train import stylegan2_trainer as TT  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

SIZE, BS, STYLE_DIM, N_MLP, WIDTH = 16, 4, 32, 2, 1 / 16
BF16_TOL = 5e-2  # x max(1, max|.|), against the JAX package's bf16 modules
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small-op torch tests run ~10x slower with one thread per core when
    the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sg2_variables(module, seed, *example):
    """Seeded numpy params in the shapes module.init gives (jax.eval_shape,
    no compile), at the JAX init's scales: kernels N(0, 1), the mapping's
    N(0, 1 / lr_mul); biases, noise weights and modulation biases (around
    1) random, so that each of them matters."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.key(0), "noise": jax.random.key(0)}, *example))["params"]

    def fill(path, leaf):
        keys = [str(getattr(p, "key", p)) for p in path]
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if keys[-1] == "kernel":
            return x * (100.0 if keys[0] == "mapping" else 1.0)
        if keys[-1] in ("bias", "weight"):
            return (1.0 if "modulation" in keys else 0.0) + 0.2 * x
        return x

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.cache
def jax_models(dtype=jnp.float32):
    gen = J.StyleGAN2Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, width_scale=WIDTH,
                               dtype=dtype)
    disc = J.StyleGAN2Discriminator(size=SIZE, width_scale=WIDTH, dtype=dtype)
    gparams = sg2_variables(J.StyleGAN2Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP,
                                                 width_scale=WIDTH), 0, jnp.zeros((2, STYLE_DIM)))
    dparams = sg2_variables(J.StyleGAN2Discriminator(size=SIZE, width_scale=WIDTH), 1,
                            jnp.zeros((2, SIZE, SIZE, 3)))
    return gen, gparams, disc, dparams


def port_models(dtype=torch.float32, remat=False, width=WIDTH):
    _, gparams, _, dparams = jax_models()
    g = T.StyleGAN2Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, width_scale=width,
                             dtype=dtype, remat=remat, device="cpu")
    g.load_state_dict(jax_params.generator_state_dict(gparams))
    d = T.StyleGAN2Discriminator(size=SIZE, width_scale=width, dtype=dtype, remat=remat,
                                 device="cpu")
    d.load_state_dict(jax_params.discriminator_state_dict(dparams))
    return g, d


class Standin:
    """A Flax module's stand-in for the JAX trainer's constructor: `init`
    returns the filled variables (no eager init), attributes come from the
    module."""

    def __init__(self, module, params):
        self.module, self.params = module, params

    def init(self, *args, **kwargs):
        return {"params": jax.tree.map(np.array, self.params)}

    def __getattr__(self, name):
        return getattr(self.module, name)


def jax_trainer(tmp_path, images, drs=False, **kwargs):
    gen, gparams, disc, dparams = jax_models()
    return JT.StyleGAN2Trainer(tmp_path, Standin(gen, gparams), Standin(disc, dparams), images,
                               num_steps=2, drs_disc=Standin(disc, dparams) if drs else None,
                               batch_size=BS, **kwargs)


def port_trainer(tmp_path, images, drs=False, dtype=torch.float32, remat=False, **kwargs):
    g, d = port_models(dtype, remat)
    drs_d = port_models(dtype, remat)[1] if drs else None
    return TT.StyleGAN2Trainer(tmp_path, g, d, images, num_steps=2, drs_disc=drs_d,
                               batch_size=BS, device="cpu", **kwargs)


# --- native/ ----------------------------------------------------------------
def test_native_runtime_matches_jax(tmp_path):
    """The port's build of diagan_io.cpp draws and gathers what the JAX
    package's does: the same seed, the same indices bit for bit, across
    calls; the same bytes from a read-only memmap; the same floats."""
    rng = np.random.default_rng(0)
    w = rng.random(300)
    w[::7] = 0.0
    for seed in (0, 11):
        ours = TN.NativeWeightedSampler(w, seed=seed)
        theirs = JN.NativeWeightedSampler(w, seed=seed)
        for count in (1, 64, 1000):
            a, b = ours.sample(count), theirs.sample(count)
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
            assert not np.isin(a, np.flatnonzero(w == 0)).any()
    images = rng.integers(0, 256, (50, 8, 8, 3), np.uint8)
    np.save(tmp_path / "x.npy", images)
    mm = np.load(tmp_path / "x.npy", mmap_mode="r")
    idx = rng.integers(0, 50, 37)
    got = TN.gather_u8(mm, idx)
    np.testing.assert_array_equal(got, JN.gather_u8(mm, idx))
    np.testing.assert_array_equal(got, images[idx])
    out = np.zeros_like(got)
    assert TN.gather_u8(mm, idx, out=out) is out and np.array_equal(out, got)
    with pytest.raises(IndexError):
        TN.gather_u8(mm, [50])
    np.testing.assert_array_equal(TN.normalize_u8(images), JN.normalize_u8(images))
    lw = rng.random(50)
    ours = TN.NativeLoader(images, 6, weights=lw, n_threads=1, queue_cap=2, seed=3)
    theirs = JN.NativeLoader(images, 6, weights=lw, n_threads=1, queue_cap=2, seed=3)
    try:
        for _ in range(3):
            (xa, ia), (xb, ib) = ours.next(), theirs.next()
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(xa, xb)
    finally:
        ours.close()
        theirs.close()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No numpy fallback: a source that does not compile raises."""
    bad = tmp_path / "diagan_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "_SRC", bad)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TN.NativeWeightedSampler(np.ones(3))
    assert not list((tmp_path / "build").iterdir())  # no half-written library left


# --- stream mode ------------------------------------------------------------
def test_stream_index_sequence_matches_jax_host_stacks(tmp_path, monkeypatch):
    """Phase 2 (weights and the twin D) in stream mode, steps 0 (an R1
    step) and 1: the port trainer gathers the indices the JAX trainer's
    _host_stacks(start, 1) gathers, in its order (D, DRS-D, R1 D, R1 DRS-D)."""
    images = synthetic_natural(40, SIZE, seed=2)[0]
    scores = np.random.default_rng(4).random(40) + 0.05
    kw = dict(sample_weights=scores, d_reg_every=16, g_reg_every=4, augment_p=None, seed=5,
              stream_data=True)
    ours = []
    gather = TT.gather_u8
    monkeypatch.setattr(TT, "gather_u8", lambda im, idx, **k: (ours.append(np.array(idx)),
                                                               gather(im, idx, **k))[1])
    tr = port_trainer(tmp_path / "port", images, drs=True, **kw)
    assert tr.stream and tr.images is None and not tr.images_np.flags.writeable
    for step in (0, 1):
        m = tr.train_step(step)
        assert all(math.isfinite(float(v)) for v in m.values())
    theirs = []
    jt = jax_trainer(tmp_path / "jax", images, drs=True, **kw)
    jt._gather = lambda im, idx: (theirs.append(np.array(idx)), JN.gather_u8(im, idx))[1]
    for step in (0, 1):
        jt._host_stacks(step, 1)
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("slab_batches", [1, 2])
def test_streamed_sweep_equals_resident_sweep(tmp_path, monkeypatch, slab_batches):
    """The logit sweep from host slabs (one or two batches of 64 a slab; 150
    images, so the last batch is padded) equals the device-resident sweep
    bit for bit; stream_data=None streams above hbm_data_budget only."""
    images = synthetic_natural(150, SIZE, seed=6)[0]
    monkeypatch.setattr(TT, "SWEEP_SLAB_BYTES", slab_batches * 64 * images[0].nbytes)
    resident = port_trainer(tmp_path / "r", images, augment_p=None, stream_data=False)
    streamed = port_trainer(tmp_path / "s", images, augment_p=None, stream_data=True)
    for tr in (resident, streamed):
        tr._record_logits(3)
    want = resident.logit_results["netD_eval"][3]
    got = streamed.logit_results["netD_eval"][3]
    assert got.shape == (150,) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    budget = images.nbytes
    assert not port_trainer(tmp_path / "a", images, hbm_data_budget=budget).stream
    assert port_trainer(tmp_path / "b", images, hbm_data_budget=budget - 1).stream


# --- bf16 -------------------------------------------------------------------
def _inject_noises(noises):
    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, J.NoiseInjection) and context.method_name == "__call__":
            layer = context.module.scope.path[-2]
            if layer == "conv1":
                i = 0
            else:
                kind, res = layer.rsplit("_", 1)
                i = 2 * int(math.log2(int(res) // 8)) + (1 if kind == "conv_up" else 2)
            return next_fun(args[0], jnp.asarray(noises[i]))
        return next_fun(*args, **kwargs)
    return nn.intercept_methods(inject)


def test_bf16_models_match_jax_bf16():
    """D (logits and features) and G (images, with style mixing) in bf16
    against the JAX package's bf16 modules on the same weights."""
    gen, gparams, disc, dparams = jax_models(jnp.bfloat16)
    g16, d16 = port_models(torch.bfloat16)
    g32, d32 = port_models()
    rng = np.random.default_rng(8)
    x = np.tanh(rng.standard_normal((BS, SIZE, SIZE, 3))).astype(np.float32)
    z1, z2 = (rng.standard_normal((2, STYLE_DIM)).astype(np.float32) for _ in range(2))
    noises = [rng.standard_normal(s).astype(np.float32) for s in g16.synthesis.noise_shapes(2)]

    def g_apply(p):
        with _inject_noises(noises):
            return gen.apply({"params": p}, [jnp.asarray(z1), jnp.asarray(z2)], 3,
                             method=J.StyleGAN2Generator.sample)

    want_logits, want_feats = jax.jit(disc.apply)({"params": dparams}, jnp.asarray(x))
    want_img = jax.jit(g_apply)(gparams)
    with torch.no_grad():
        logits, feats = d16(torch.from_numpy(x))
        img = g16.sample([torch.from_numpy(z1), torch.from_numpy(z2)], 3,
                         noises=[torch.from_numpy(n) for n in noises])
        logits32 = d32(torch.from_numpy(x))[0]
        img32 = g32.sample([torch.from_numpy(z1), torch.from_numpy(z2)], 3,
                           noises=[torch.from_numpy(n) for n in noises])
    for got, want, fp32 in ((logits, want_logits, logits32), (feats["features"],
                            want_feats["features"], None), (img, want_img, img32)):
        assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
        want = np.asarray(want)
        scale = max(1.0, np.abs(want).max())
        assert np.abs(got.numpy() - want).max() <= BF16_TOL * scale
        if fp32 is not None:  # the port's bf16 ran in bf16: it is not its fp32
            assert not torch.equal(got, fp32)


# --- remat ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_keeps_keys_losses_and_gradients(tmp_path, dtype):
    """Per-layer checkpointing changes no state_dict key, and no loss or
    gradient bit of the D step (ADA), R1 (double backward through D), the G
    step and path regularisation (double backward through G), nor the
    images G draws its own noise for."""
    images = synthetic_natural(8, SIZE, seed=3)[0]
    rng = np.random.default_rng(1)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    g0, d0 = port_models()
    real = torch.tanh(normal(BS, SIZE, SIZE, 3))
    fakes = TT.FakeDraws(normal(BS, STYLE_DIM), normal(BS, STYLE_DIM), 3,
                         [normal(*s) for s in g0.synthesis.noise_shapes(BS)])
    aug = [sample_augment(BS, 0.8, SIZE, SIZE, torch.Generator().manual_seed(k))
           for k in range(3)]
    path = (normal(BS // 2, STYLE_DIM), [normal(*s) for s in g0.synthesis.noise_shapes(BS // 2)],
            normal(BS // 2, SIZE, SIZE, 3))
    runs = {}
    for remat in (False, True):
        tr = port_trainer(tmp_path / str(remat), images, dtype=dtype, remat=remat, augment_p=0.8)
        assert list(tr.gen.state_dict()) == list(g0.state_dict())
        assert list(tr.disc.state_dict()) == list(d0.state_dict())
        out = []
        for run, net in ((lambda: tr.d_step(tr.disc, tr.d_optim, real, fakes, aug[0], aug[1]),
                          tr.disc),
                         (lambda: tr.r1_step(tr.disc, tr.d_optim, real, aug[2]), tr.disc),
                         (lambda: tr.g_step(fakes, aug[0]), tr.gen),
                         (lambda: tr.path_step(*path), tr.gen)):
            m = run()
            out.append(({k: float(v) for k, v in m.items()},
                        [p.grad.clone() for p in net.parameters() if p.grad is not None]))
        runs[remat] = out
    for (m0, g0_), (m1, g1_) in zip(runs[False], runs[True]):
        assert m0 == m1 and len(g0_) == len(g1_) > 0
        assert all(torch.equal(a, b) for a, b in zip(g0_, g1_))
    # noise drawn from a generator: remat draws it before the checkpointed
    # layers, in the layers' order, so the images are the same
    z = normal(2, STYLE_DIM)
    imgs = [port_models(dtype, remat)[0](z, generator=torch.Generator().manual_seed(5))
            for remat in (False, True)]
    assert imgs[0].requires_grad and torch.equal(imgs[0], imgs[1])


# --- the CLIs ---------------------------------------------------------------
def _small_models(monkeypatch):
    monkeypatch.setattr(train_ffhq, "StyleGAN2Generator", functools.partial(
        T.StyleGAN2Generator, style_dim=STYLE_DIM, n_mlp=N_MLP, width_scale=WIDTH))
    monkeypatch.setattr(train_ffhq, "StyleGAN2Discriminator", functools.partial(
        T.StyleGAN2Discriminator, width_scale=WIDTH))


def _cli_args(tmp_path, n=24):
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    np.save(data / f"ffhq_{SIZE}.npy", synthetic_natural(n, SIZE, seed=5)[0])
    return ["-d", "ffhq", "-r", str(data), "--size", str(SIZE), "--batch", str(BS),
            "--augment", "--augment_p", "0.5", "--work_dir", str(tmp_path), "--device", "cpu",
            "--d_reg_every", "2", "--g_reg_every", "2", "--seed", "3"]


def test_dispatch_flags_change_nothing(tmp_path, monkeypatch):
    """--no_fuse and --max_chunk 1 give the plain run's losses over two
    steps, bit for bit; --data_parallel still raises."""
    _small_models(monkeypatch)
    common = _cli_args(tmp_path) + ["--iter", "2", "--logit_save_steps", "0"]
    step = TT.StyleGAN2Trainer.train_step
    losses = []
    monkeypatch.setattr(TT.StyleGAN2Trainer, "train_step", lambda self, s: losses[-1].append(
        {k: float(v) for k, v in step(self, s).items()}) or {})
    runs = {}
    for name, flags in (("plain", []), ("no_fuse", ["--no_fuse"]),
                        ("max_chunk", ["--max_chunk", "1"])):
        losses.append([])
        tr = train_ffhq.main(common + ["--exp_name", name] + flags)
        runs[name] = losses[-1]
        assert (tr.fuse_steps, tr.max_chunk) == (name != "no_fuse",
                                                  1 if name == "max_chunk" else None)
    assert len(runs["plain"]) == 2 and "r1" in runs["plain"][0]
    assert runs["no_fuse"] == runs["plain"] == runs["max_chunk"]
    with pytest.raises(NotImplementedError, match="--data_parallel"):
        train_ffhq.main(common + ["--exp_name", "dp", "--data_parallel"])
    assert train_ffhq.NOT_PORTED == ("data_parallel",)


def test_cli_flags_through_both_phases(tmp_path, monkeypatch):
    """Phase 1 with --bf16 --remat --stream_data --no_fuse --max_chunk 4 and
    logit sweeps, then phase 2 from its checkpoint with --bf16 --stream_data
    (weighted stream, twin D)."""
    _small_models(monkeypatch)
    common = _cli_args(tmp_path)
    tr1 = train_ffhq.main(common + ["--exp_name", "p1", "--iter", "4", "--logit_save_steps", "1",
                                    "--save_logit_after", "0", "--bf16", "--remat",
                                    "--stream_data", "--no_fuse", "--max_chunk", "4"])
    assert tr1.stream and tr1.gen.synthesis.remat and tr1.disc.remat
    assert tr1.gen.synthesis.dtype == tr1.disc.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tr1.gen.parameters())
    assert all(math.isfinite(float(v)) for v in tr1.metrics.values())
    with open(tmp_path / "p1" / "logits_netD.pkl", "rb") as f:
        logits = pickle.load(f)
    assert sorted(logits) == [1, 2, 3] and all(np.isfinite(v).all() for v in logits.values())
    tr2 = train_ffhq_phase2.main(common + [
        "--exp_name", "p2", "--baseline_exp_name", "p1", "--p1_step", "4", "--iter", "6",
        "--resample_score", "ldr_conf_3.0_ratio_50", "--bf16", "--stream_data"])
    assert tr2.stream and tr2._w_sampler is not None and tr2.drs_disc.dtype == torch.bfloat16
    assert (tmp_path / "p2" / "checkpoint" / "000006.pt").is_file()
    assert all(math.isfinite(float(v)) for v in tr2.metrics.values())


# --- prepare_data -----------------------------------------------------------
def _write_pngs(root):
    from PIL import Image

    root.mkdir()
    rng = np.random.default_rng(12)
    for i, (w, h) in enumerate(((40, 30), (24, 24), (17, 33))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(root / f"{i:02d}.png")


def test_prepare_npy_matches_jax(tmp_path):
    """The same resize and centre-crop, the same ffhq_{size}.npy bytes; the
    image-directory branch of load_ffhq gives the JAX package's array."""
    _write_pngs(tmp_path / "img")
    ours = TF.prepare_npy(tmp_path / "img", tmp_path / "ours", sizes=(8, 16))
    theirs = JF.prepare_npy(tmp_path / "img", tmp_path / "theirs", sizes=(8, 16))
    for size in (8, 16):
        name = f"ffhq_{size}.npy"
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes()
        np.testing.assert_array_equal(ours[size], theirs[size])
    for pkg in ("ours", "theirs"):
        (tmp_path / f"dir_{pkg}").mkdir()
        for f in (tmp_path / "img").iterdir():
            (tmp_path / f"dir_{pkg}" / f.name).write_bytes(f.read_bytes())
    np.testing.assert_array_equal(TF.load_ffhq(tmp_path / "dir_ours", size=16),
                                  JF.load_ffhq(tmp_path / "dir_theirs", size=16))


def test_prepare_data_cli_matches_the_root_script(tmp_path):
    """cli.prepare_data keeps stylegan2/prepare_data.py's argparse surface and
    its error when --path or --out is missing, and writes the store."""
    saved_path = list(sys.path)
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from dump_argparse import capture_script

        want = capture_script(str(REPO / "stylegan2" / "prepare_data.py"))
        got = capture_script(str(REPO / "diagan_tpu_torch" / "cli" / "prepare_data.py"))
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("dump_argparse", None)
    assert len(want) == 5 and got == want
    for argv in ([], ["--path", str(tmp_path)], ["--out", str(tmp_path)]):
        with pytest.raises(SystemExit):
            prepare_data.main(argv)
    _write_pngs(tmp_path / "img")
    out = prepare_data.main(["--path", str(tmp_path / "img"), "--out", str(tmp_path / "store"),
                             "--size", "8,16"])
    assert sorted(out) == [8, 16] and out[16].shape == (3, 16, 16, 3)
    assert sorted(p.name for p in (tmp_path / "store").iterdir()) == ["ffhq_16.npy", "ffhq_8.npy"]
