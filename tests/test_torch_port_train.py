"""Port StyleGAN2 + ADA training (diagan_tpu_torch.train, cli) against JAX.

One training step's pieces on the same Flax weights (bridged with
diagan_tpu_torch.utils.jax_params) and the same injected draws, drawn with
numpy or the JAX samplers and handed to both sides: the D loss with ADA, R1,
the G step through ADA, and path regularisation with pl_mean; the JAX side
is written out from the formulas of diagan_tpu/train/stylegan2_trainer.py.
The RNGs differ, so nothing compares by seed. Losses and every parameter
gradient at atol 3e-4 / rtol 1e-3 (the StyleGAN2 parity tolerance of the
other port tests). Then one Adam update against optax, the EMA, and phase 1
-> logits -> scores -> phase 2 through the CLIs at 16 px, width 1/16.
"""
import functools
import math
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from test_torch_port_discriminator import _randomize_biases  # noqa: E402
from test_torch_port_generator import (  # noqa: E402
    N_MLP,
    STYLE_DIM,
    WIDTH,
    _noise_index,
    _randomize_zero_init,
)

from diagan_tpu.data.ffhq import load_ffhq as jax_load_ffhq  # noqa: E402
from diagan_tpu.models import ada as JA  # noqa: E402
from diagan_tpu.models import losses as JL  # noqa: E402
from diagan_tpu.models import stylegan2 as J  # noqa: E402
from diagan_tpu.score import calculate_scores as jax_calculate_scores  # noqa: E402
from diagan_tpu.train import stylegan2_trainer as JT  # noqa: E402
from diagan_tpu_torch.cli import train_ffhq, train_ffhq_phase2  # noqa: E402
from diagan_tpu_torch.data.ffhq import load_ffhq  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.eval.evaluate import read_stylegan2_ckpt  # noqa: E402
from diagan_tpu_torch.models import ada as TA  # noqa: E402
from diagan_tpu_torch.models import stylegan2 as T  # noqa: E402
from diagan_tpu_torch.score import calculate_scores  # noqa: E402
from diagan_tpu_torch.train import stylegan2_trainer as TT  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

SIZE, BS, P_AUG, CUTOFF = 16, 4, 0.7, 3
ATOL, RTOL = 3e-4, 1e-3
PAD_BUCKETS = (0.25, 0.5)  # the trainer's buckets at ada_pad_frac 0.75


@functools.cache
def _setup():
    """JAX modules and params, and every draw of one step, as numpy. (Every
    JAX computation in this file is jitted: eager Flax is slow on the CPU.)"""
    gen = J.StyleGAN2Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, width_scale=WIDTH)
    gv = jax.jit(lambda k: gen.init({"params": k, "noise": k}, jnp.zeros((2, STYLE_DIM))))(
        jax.random.key(0))
    disc = J.StyleGAN2Discriminator(size=SIZE, width_scale=WIDTH)
    dv = jax.jit(lambda k: disc.init({"params": k}, jnp.zeros((4, SIZE, SIZE, 3))))(
        jax.random.key(1))
    gparams = _randomize_zero_init(gv["params"], 0)
    dparams = _randomize_biases(dv["params"], 1)
    rng = np.random.default_rng(21)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    n_noise = [(BS, 4, 4, 1)] + [(BS, r, r, 1) for r in (8, 8, 16, 16)]
    draws = {
        "real": np.tanh(normal(BS, SIZE, SIZE, 3)),
        "z1": normal(BS, STYLE_DIM), "z2": normal(BS, STYLE_DIM),
        "noises": [normal(*s) for s in n_noise],
        "zp": normal(BS // 2, STYLE_DIM),
        "noises_p": [normal(BS // 2, *s[1:]) for s in n_noise],
        "path_noise": normal(BS // 2, SIZE, SIZE, 3),
    }
    affine = jax.jit(JA.sample_affine_matrices, static_argnums=(1, 2, 3, 4))
    color = jax.jit(JA.sample_color_matrices, static_argnums=(1, 2))
    for i in range(3):  # (affine, colour) pairs of three augment calls
        k1, k2 = jax.random.split(jax.random.key(40 + i))
        draws[f"aug{i}"] = (np.array(affine(k1, BS, P_AUG, SIZE, SIZE)),
                            np.array(color(k2, BS, P_AUG)))
    return gen, gparams, disc, dparams, draws


def _jax_synth(gen, params, fn, noises):
    """Run `fn` (a method of the generator) with the noises injected."""
    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, J.NoiseInjection) and context.method_name == "__call__":
            return next_fun(args[0], jnp.asarray(noises[_noise_index(context.module.scope.path[-2])]))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(inject):
        return gen.apply({"params": params}, method=fn)


def _jax_fake(gen, params, d):
    return _jax_synth(gen, params, lambda m: m.sample([jnp.asarray(d["z1"]), jnp.asarray(d["z2"])],
                                                      CUTOFF), d["noises"])


def _jax_augment(x, aug):
    G, C = aug
    out = JA.apply_affine(x, jnp.asarray(G), pad_buckets=PAD_BUCKETS)
    return JA.apply_color(out, jnp.asarray(C))


def _port_trainer(tmp_path, images=None):
    _, gparams, _, dparams, _ = _setup()
    g = T.StyleGAN2Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, width_scale=WIDTH,
                             device="cpu")
    g.load_state_dict(jax_params.generator_state_dict(gparams))
    d = T.StyleGAN2Discriminator(size=SIZE, width_scale=WIDTH, device="cpu")
    d.load_state_dict(jax_params.discriminator_state_dict(dparams))
    if images is None:
        images = synthetic_natural(8, SIZE, seed=3)[0]
    return TT.StyleGAN2Trainer(tmp_path, g, d, images, num_steps=1, batch_size=BS,
                               r1_weight=10.0, augment_p=P_AUG, device="cpu")


def _fakes(d):
    return TT.FakeDraws(torch.from_numpy(d["z1"]), torch.from_numpy(d["z2"]), CUTOFF,
                        [torch.from_numpy(n) for n in d["noises"]])


def _aug(d, i):
    return tuple(torch.from_numpy(a) for a in d[f"aug{i}"])


def _assert_grads(module, jax_grads, bridge):
    want = bridge(jax.device_get(jax_grads))
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        # a parameter the loss does not reach has no grad here and zeros in JAX
        g = torch.zeros_like(want[name]) if got[name] is None else got[name]
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_d_step_with_ada_matches_jax(tmp_path):
    gen, gparams, disc, dparams, d = _setup()

    def loss_fn(p, gp):
        real_a = _jax_augment(jnp.asarray(d["real"]), d["aug0"])
        fake_a = _jax_augment(jax.lax.stop_gradient(_jax_fake(gen, gp, d)), d["aug1"])
        rp = disc.apply({"params": p}, real_a)[0]
        fp = disc.apply({"params": p}, fake_a)[0]
        return JL.d_logistic_loss(rp, fp)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(dparams, gparams)
    tr = _port_trainer(tmp_path)
    m = tr.d_step(tr.disc, tr.d_optim, torch.from_numpy(d["real"]), _fakes(d), _aug(d, 0),
                  _aug(d, 1))
    np.testing.assert_allclose(float(m["d"]), float(loss), atol=ATOL, rtol=RTOL)
    _assert_grads(tr.disc, grads, jax_params.discriminator_state_dict)


def test_r1_matches_jax(tmp_path):
    _, _, disc, dparams, d = _setup()

    def r1_fn(p):  # stylegan2_trainer.py d_r1_for
        real_a = _jax_augment(jnp.asarray(d["real"]), d["aug2"])
        g = jax.grad(lambda x: jnp.sum(disc.apply({"params": p}, x)[0]))(real_a)
        pen = jnp.sum(g.reshape(BS, -1) ** 2) / BS
        return 10.0 / 2 * pen * 16, pen

    (_, pen), grads = jax.jit(jax.value_and_grad(r1_fn, has_aux=True))(dparams)
    tr = _port_trainer(tmp_path)
    m = tr.r1_step(tr.disc, tr.d_optim, torch.from_numpy(d["real"]), _aug(d, 2))
    np.testing.assert_allclose(float(m["r1"]), float(pen), atol=ATOL, rtol=RTOL)
    _assert_grads(tr.disc, grads, jax_params.discriminator_state_dict)


def test_g_step_through_ada_matches_jax(tmp_path):
    gen, gparams, disc, dparams, d = _setup()

    def loss_fn(p, dp):
        fake = _jax_augment(_jax_fake(gen, p, d), d["aug0"])
        return JL.g_nonsaturating_loss(disc.apply({"params": dp}, fake)[0])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(gparams, dparams)
    tr = _port_trainer(tmp_path)
    m = tr.g_step(_fakes(d), _aug(d, 0))
    np.testing.assert_allclose(float(m["g"]), float(loss), atol=ATOL, rtol=RTOL)
    _assert_grads(tr.gen, grads, jax_params.generator_state_dict)
    assert all(p.requires_grad for p in tr.disc.parameters())


def test_g_step_through_polyphase_ada_matches_jax(tmp_path, monkeypatch):
    """The G step with the polyphase opt-in on (monkeypatched: on the CPU the
    environment variable is not honoured) against the G step through JAX's
    polyphase apply_affine; the trainer's pad buckets are ignored under
    polyphase in both."""
    gen, gparams, disc, dparams, d = _setup()

    def loss_fn(p, dp):
        G, C = d["aug0"]
        fake = JA.apply_affine(_jax_fake(gen, p, d), jnp.asarray(G), polyphase=True)
        fake = JA.apply_color(fake, jnp.asarray(C))
        return JL.g_nonsaturating_loss(disc.apply({"params": dp}, fake)[0])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(gparams, dparams)
    calls, resample = [], TA._polyphase_resample
    monkeypatch.setattr(TA, "_polyphase_auto", lambda device: True)
    monkeypatch.setattr(TA, "_polyphase_resample", lambda *a: calls.append(a[2]) or resample(*a))
    tr = _port_trainer(tmp_path)
    m = tr.g_step(_fakes(d), _aug(d, 0))
    assert calls == [SIZE - 1]  # one augment, at the largest pad min(h - 1, 0.75 h + 6)
    np.testing.assert_allclose(float(m["g"]), float(loss), atol=ATOL, rtol=RTOL)
    _assert_grads(tr.gen, grads, jax_params.generator_state_dict)


def test_path_regularisation_matches_jax(tmp_path):
    gen, gparams, _, _, d = _setup()
    pl_mean = 1.5
    n_latent = int(math.log2(SIZE)) * 2 - 2

    def path_fn(p):  # stylegan2_trainer.py g_path_reg, with the draws injected
        w = gen.apply({"params": p}, jnp.asarray(d["zp"]), method=lambda m, z: m.mapping(z))
        styles = jnp.repeat(w[:, None, :], n_latent, axis=1)

        def synth(s):
            return _jax_synth(gen, p, lambda m: m.synthesis(s), d["noises_p"])

        imgs, vjp_fn = jax.vjp(synth, styles)
        (grads_w,) = vjp_fn(jnp.asarray(d["path_noise"]) / math.sqrt(SIZE * SIZE))
        lengths = jnp.sqrt(jnp.sum(grads_w**2, axis=(1, 2)) + 1e-12)
        new_mean = pl_mean + 0.01 * (jnp.mean(lengths) - pl_mean)
        pen = jnp.mean((lengths - new_mean) ** 2)
        return 2.0 * 4 * pen + 0.0 * jnp.sum(imgs[:1]), (pen, lengths, new_mean)

    (_, (pen, lengths, new_mean)), grads = jax.jit(
        jax.value_and_grad(path_fn, has_aux=True))(gparams)
    tr = _port_trainer(tmp_path)
    tr.pl_mean = torch.tensor(pl_mean)
    m = tr.path_step(torch.from_numpy(d["zp"]), [torch.from_numpy(n) for n in d["noises_p"]],
                     torch.from_numpy(d["path_noise"]))
    for got, want in ((m["path"], pen), (m["path_length"], jnp.mean(lengths)),
                      (tr.pl_mean, new_mean)):
        np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
    _assert_grads(tr.gen, grads, jax_params.generator_state_dict)


@pytest.mark.parametrize("reg_every", [16, 4, 0])
def test_reg_ratio_adam_matches_optax(reg_every):
    rng = np.random.default_rng(reg_every)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    tx = JT.reg_ratio_adam(0.002, reg_every)
    params, state = jnp.asarray(p0), None
    state = tx.init(params)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = TT.reg_ratio_adam([w], 0.002, reg_every)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=1e-6, atol=1e-7)


def test_ema_matches_jax(tmp_path):
    assert TT.EMA_DECAY == JT.EMA_DECAY
    tr = _port_trainer(tmp_path)
    with torch.no_grad():
        for p in tr.gen.parameters():
            p.add_(1.0)
    ema0 = [e.clone() for e in tr.g_ema.parameters()]
    tr.update_ema()
    for e0, e, p in zip(ema0, tr.g_ema.parameters(), tr.gen.parameters()):
        want = e0.numpy() * JT.EMA_DECAY + p.detach().numpy() * (1 - JT.EMA_DECAY)
        np.testing.assert_allclose(e.numpy(), want, rtol=1e-6, atol=1e-7)


# --- phase 1 -> logits -> scores -> phase 2, through the CLIs ----------------
def _small_models(monkeypatch):
    monkeypatch.setattr(train_ffhq, "StyleGAN2Generator", functools.partial(
        T.StyleGAN2Generator, style_dim=STYLE_DIM, n_mlp=N_MLP, width_scale=WIDTH))
    monkeypatch.setattr(train_ffhq, "StyleGAN2Discriminator", functools.partial(
        T.StyleGAN2Discriminator, width_scale=WIDTH))


def test_phase1_scores_phase2_end_to_end(tmp_path, monkeypatch):
    _small_models(monkeypatch)
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / f"ffhq_{SIZE}.npy", synthetic_natural(24, SIZE, seed=5)[0])
    common = ["-d", "ffhq", "-r", str(data), "--size", str(SIZE), "--batch", str(BS),
              "--augment", "--augment_p", "0.5", "--work_dir", str(tmp_path), "--device", "cpu",
              "--d_reg_every", "2", "--g_reg_every", "2", "--seed", "3"]
    tr1 = train_ffhq.main(common + ["--exp_name", "p1", "--iter", "4", "--logit_save_steps", "1",
                                    "--save_logit_after", "0"])
    assert {"d", "g", "r1", "path", "path_length"} <= set(tr1.metrics)
    assert all(math.isfinite(float(v)) for v in tr1.metrics.values())

    # the logits, scored by the JAX package and by the port's copy
    with open(tmp_path / "p1" / "logits_netD.pkl", "rb") as f:
        logits = pickle.load(f)
    assert sorted(logits) == [1, 2, 3] and all(v.shape == (24,) for v in logits.values())
    ours = calculate_scores(logits, start_epoch=4 - 5000, end_epoch=4)
    theirs = jax_calculate_scores(logits, start_epoch=4 - 5000, end_epoch=4)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(theirs[key]), err_msg=key)

    # the checkpoint round-trips: weights, EMA, Adam moments, ada_aug_p, pl_mean
    ckpt = tmp_path / "p1" / "checkpoint" / "000004.pt"
    tr1.pl_mean = torch.tensor(0.25)
    tr1._save_ckpt(4)
    tr_back, start = train_ffhq.make_trainer(train_ffhq.build_parser().parse_args(
        common + ["--exp_name", "p1", "--iter", "4", "--ckpt", str(ckpt), "--lr", "0.001"]))
    assert start == 4 and tr_back.ada_aug_p == 0.5 and float(tr_back.pl_mean) == 0.25
    for a, b in ((tr1.gen, tr_back.gen), (tr1.disc, tr_back.disc), (tr1.g_ema, tr_back.g_ema)):
        for (na, ta), (nb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert na == nb and torch.equal(ta, tb), na
    for oa, ob in ((tr1.g_optim, tr_back.g_optim), (tr1.d_optim, tr_back.d_optim)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert sa.keys() == sb.keys() and len(sa) > 0
        for k in sa:
            for field in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa[k][field], sb[k][field])
        # this run's learning rate, not the checkpoint's
        assert ob.param_groups[0]["lr"] == pytest.approx(0.001 * oa.param_groups[0]["lr"] / 0.002)

    tr2 = train_ffhq_phase2.main(common + [
        "--exp_name", "p2", "--baseline_exp_name", "p1", "--p1_step", "4", "--iter", "6",
        "--resample_score", "ldr_conf_3.0_ratio_50"])
    assert tr2.drs_disc is not None and tr2.weights is not None
    weights = np.asarray(ours["ldr_conf_3.0_ratio_50"])
    np.testing.assert_allclose(tr2.weights.numpy(), np.maximum(weights, 1e-6), rtol=1e-6)

    # the phase-2 checkpoint feeds sampling and DRS
    ckpt2 = tmp_path / "p2" / "checkpoint" / "000006.pt"
    raw = torch.load(ckpt2, weights_only=True)
    assert {"g", "d", "g_ema", "g_optim", "d_optim", "ada_aug_p", "pl_mean", "step", "drs_d",
            "drs_d_optim"} <= set(raw) and raw["step"] == 6
    g = T.StyleGAN2Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, width_scale=WIDTH,
                             device="cpu")
    d = T.StyleGAN2Discriminator(size=SIZE, width_scale=WIDTH, device="cpu")
    read_stylegan2_ckpt(ckpt2, g, d, use_drs=True)
    for name, t in g.state_dict().items():
        assert torch.equal(t, raw["g_ema"][name]), name
    for name, t in d.state_dict().items():
        assert torch.equal(t, raw["drs_d"][name]), name
    with torch.no_grad():
        assert torch.isfinite(g(torch.randn(2, STYLE_DIM))).all()


def test_load_ffhq_matches_jax(tmp_path):
    """The npy cache (memory-mapped) and the procedural fallback, byte for byte."""
    np.save(tmp_path / "ffhq_16.npy", synthetic_natural(6, 16, seed=1)[0])
    np.testing.assert_array_equal(load_ffhq(tmp_path, size=16), jax_load_ffhq(tmp_path, size=16))
    empty = tmp_path / "none"
    empty.mkdir()
    ours = load_ffhq(empty, size=16, fallback_n=5)
    theirs = jax_load_ffhq(empty, size=16, fallback_n=5)
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_sigterm_flushes_a_resumable_checkpoint(tmp_path):
    """SIGTERM stops after the current step and writes that step's checkpoint."""
    import os
    import signal

    tr = _port_trainer(tmp_path)
    tr.num_steps, tr.save_every, tr.log_every = 10, 100, 100
    step = tr.train_step

    def step_then_term(s):
        out = step(s)
        if s == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    tr.train_step = step_then_term
    tr.train()
    assert sorted(p.name for p in (tmp_path / "checkpoint").glob("*.pt")) == ["000002.pt"]
    assert tr.load_ckpt(tmp_path / "checkpoint" / "000002.pt") == 2


def test_index_samplers_distribution():
    """Weighted draws with replacement follow the eps-floored weights (the
    JAX sampler's categorical over log-weights); uniform draws cover all."""
    from diagan_tpu_torch.data.sampler import (
        sample_uniform_indices,
        sample_weighted_indices,
        weights_from_scores,
    )

    w = weights_from_scores(np.array([1.0, 3.0, 0.0, -1.0]), "cpu")
    assert w.tolist() == pytest.approx([1.0, 3.0, 1e-6, 1e-6])
    n = 40000
    idx = sample_weighted_indices(w, n, torch.Generator().manual_seed(0))
    freq = np.bincount(idx.numpy(), minlength=4) / n
    p = w.numpy() / w.numpy().sum()
    assert np.all(np.abs(freq - p) < 4 * np.sqrt(p * (1 - p) / n) + 1e-4)
    u = sample_uniform_indices(7, n, torch.Generator().manual_seed(1), "cpu").numpy()
    assert u.min() == 0 and u.max() == 6
    assert np.all(np.abs(np.bincount(u) / n - 1 / 7) < 4 * np.sqrt(6 / 49 / n))


def test_cli_flags_match_the_root_scripts():
    """The training CLIs keep the argparse surfaces of stylegan2/train_ffhq.py
    and stylegan2/train_ffhq_phase2.py (option strings, defaults, types,
    actions), plus --device; captured live by scripts/dump_argparse.py."""
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    saved_path = list(sys.path)
    sys.path.insert(0, str(repo / "scripts"))
    try:
        from dump_argparse import capture_script

        # the root phase-2 script imports `train_ffhq` from its own folder:
        # capture both root scripts before any port folder joins sys.path
        want = [capture_script(str(repo / "stylegan2" / f"{n}.py"))
                for n in ("train_ffhq", "train_ffhq_phase2")]
        got = [capture_script(str(repo / "diagan_tpu_torch" / "cli" / f"{n}.py"))
               for n in ("train_ffhq", "train_ffhq_phase2")]
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("train_ffhq", None)
        sys.modules.pop("dump_argparse", None)
    assert [len(w) for w in want] == [38, 41]  # the whole surfaces were captured
    for ours, theirs in zip(got, want):
        device = ours.pop("--device")
        assert device["default"] == "cuda" and device["type"] == "str"
        assert ours == theirs
    assert {"--p1_step", "--baseline_exp_name", "--resample_score"} <= set(got[1])
