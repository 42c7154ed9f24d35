"""StyleGAN2 checkpoints across the packages: the port reads the JAX
package's msgpack files and the reference's (rosinality's) `{iter:06d}.pt`
beside its own, in StyleGAN2Trainer.load_ckpt and read_stylegan2_ckpt.

- utils/flax_msgpack.py against flax.serialization.msgpack_restore on a
  real JAX StyleGAN2Trainer payload (phase 2: g, d, g_ema, drs_d, both
  optax states, ada_aug_p, pl_mean, step), with the largest leaves forced
  into Flax's chunked form: the same tree, leaf for leaf, bit for bit;
- the readers with sys.modules["msgpack"] and sys.modules["flax"] set to
  None: they need neither;
- load_ckpt of a JAX checkpoint restores params, EMA, Adam moments (optax
  mu / nu, count as the step), pl_mean, ada_aug_p and step exactly; then
  one D step and one G step with the EMA, from the same injected draws,
  against the JAX trainer's resumed state stepped by optax: params and EMA
  within 1e-5 absolute + 1e-6 relative (the mapping's weights sit near 100,
  where one fp32 ulp is 7.6e-6), moments within the StyleGAN2 gradient
  tolerance (3e-4 absolute + 1e-3 relative);
- load_ckpt, read_stylegan2_ckpt and cli.generate of a reference file built
  with tests/test_torch_import.py's _fabricate_sg2_g_sd / _fabricate_sg2_d_sd
  (16 px, full width): exactly the JAX package's import_stylegan2_* bridged
  through utils/jax_params.py; fresh moments, the step from the file name;
  an unknown key raises.

Small models for the JAX files: 16 px, width 1/16, style_dim 32, n_mlp 2,
batch 4, variables from jax.eval_shape filled with seeded numpy.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import serialization  # noqa: E402
from test_torch_import import _fabricate_sg2_d_sd, _fabricate_sg2_g_sd  # noqa: E402
from test_torch_port_ffhq_flags import (  # noqa: E402
    BS,
    SIZE,
    STYLE_DIM,
    _inject_noises,
    jax_models,
    jax_trainer,
    port_trainer,
)

from diagan_tpu.models import losses as JL  # noqa: E402
from diagan_tpu.models import stylegan2 as J  # noqa: E402
from diagan_tpu.train import stylegan2_trainer as JT  # noqa: E402
from diagan_tpu.utils import torch_import as TI  # noqa: E402
from diagan_tpu_torch.cli import generate  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.eval.evaluate import read_stylegan2_ckpt  # noqa: E402
from diagan_tpu_torch.models import stylegan2 as T  # noqa: E402
from diagan_tpu_torch.train import stylegan2_trainer as TT  # noqa: E402
from diagan_tpu_torch.train.checkpoint import read_stylegan2_file  # noqa: E402
from diagan_tpu_torch.utils import flax_msgpack, jax_params  # noqa: E402

PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-6  # params and EMA after one resumed step
MOMENT_ATOL, MOMENT_RTOL = 3e-4, 1e-3  # the StyleGAN2 gradient parity tolerance
COUNT, PL_MEAN, ADA_P = 7, 0.75, 0.3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images():
    return synthetic_natural(24, SIZE, seed=4)[0]


def _random_adam(state, seed):
    """An optax.adam state at update COUNT with random moments (nu > 0)."""
    rng = np.random.default_rng(seed)
    adam, rest = state

    def fill(leaf, lo):
        return jnp.asarray(lo + rng.random(leaf.shape).astype(np.float32) * 0.02)

    return (adam._replace(count=jnp.asarray(COUNT, jnp.int32),
                          mu=jax.tree.map(lambda x: fill(x, -0.01), adam.mu),
                          nu=jax.tree.map(lambda x: fill(x, 1e-3), adam.nu)), rest)


def _jax_checkpoint(tmp_path, step=5):
    """A JAX phase-2 StyleGAN2Trainer's checkpoint, with random Adam moments,
    distinct EMA and twin-D weights, pl_mean and ada_aug_p. Returns (path,
    the trainer)."""
    jt = jax_trainer(tmp_path / "jax", _images(), drs=True, augment_p=ADA_P)
    jt.g_state = jt.g_state.replace(opt_state=_random_adam(jt.g_state.opt_state, 1))
    jt.d_state = jt.d_state.replace(opt_state=_random_adam(jt.d_state.opt_state, 2))
    jt.d_drs_state = jt.d_drs_state.replace(
        params=jax.tree.map(lambda x: x * 0.5, jt.d_drs_state.params),
        opt_state=_random_adam(jt.d_drs_state.opt_state, 3))
    jt.g_ema = jax.tree.map(lambda x: x * 0.9, jt.g_ema)
    jt.pl_mean = jnp.asarray(PL_MEAN)
    jt._save_ckpt(step)
    return tmp_path / "jax" / "checkpoint" / f"{step:06d}.pt", jt


def _tree_equal(a, b, path="root"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        assert type(a) is type(b), (path, type(a), type(b))
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            assert a == b, path


def test_msgpack_decoder_matches_flax(tmp_path, monkeypatch):
    """The decoder against Flax's own restore, on a JAX trainer's payload
    whose largest leaves Flax wrote in its chunked form."""
    jt = _jax_checkpoint(tmp_path)[1]
    largest = max(x.nbytes for x in jax.tree.leaves(jax.device_get(jt.g_state.params)))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", largest // 3)
    jt._save_ckpt(9)
    data = (tmp_path / "jax" / "checkpoint" / "000009.pt").read_bytes()
    assert b"__msgpack_chunked_array__" in data
    want = serialization.msgpack_restore(data)
    got = flax_msgpack.msgpack_restore(data)
    _tree_equal(got, want)
    assert set(got) == {"g", "d", "g_ema", "g_optim", "d_optim", "ada_aug_p", "pl_mean", "step",
                        "drs_d", "drs_d_optim"}
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(data[:-3])


def test_readers_need_neither_msgpack_nor_flax(tmp_path, monkeypatch):
    path = _jax_checkpoint(tmp_path)[0]
    for name in ("msgpack", "flax", "flax.serialization"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import flax.serialization  # noqa: F401
    raw = read_stylegan2_file(path)
    assert raw["format"] == "jax" and raw["step"] == 5
    tr = port_trainer(tmp_path / "port", _images(), drs=True)
    assert tr.load_ckpt(path) == 5
    g, d = T.StyleGAN2Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=2, width_scale=1 / 16,
                                device="cpu"), tr.disc
    read_stylegan2_ckpt(path, g, d, use_drs=True)
    for name, t in g.state_dict().items():
        assert torch.equal(t, raw["g_ema"][name])


def _injected_draws():
    rng = np.random.default_rng(17)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    noises = [normal(BS, r, r, 1) for r in (4, 8, 8, 16, 16)]
    return {"real": np.tanh(normal(BS, SIZE, SIZE, 3)), "z1": normal(BS, STYLE_DIM),
            "z2": normal(BS, STYLE_DIM), "noises": noises}


def _jax_resumed_step(jb, d):
    """One D step and one G step (with the EMA) of the JAX trainer's resumed
    state `jb`, from the injected draws and with optax's own update."""
    gen, _, disc, _ = jax_models()

    def fake(gp):
        with _inject_noises(d["noises"]):
            return gen.apply({"params": gp}, [jnp.asarray(d["z1"]), jnp.asarray(d["z2"])], 3,
                             method=J.StyleGAN2Generator.sample)

    def d_loss(dp, gp):
        rp = disc.apply({"params": dp}, jnp.asarray(d["real"]))[0]
        fp = disc.apply({"params": dp}, jax.lax.stop_gradient(fake(gp)))[0]
        return JL.d_logistic_loss(rp, fp)

    def g_loss(gp, dp):
        return JL.g_nonsaturating_loss(disc.apply({"params": dp}, fake(gp))[0])

    out = {}
    for name, loss, state, tx, other in (("d", d_loss, "d_state", jb.tx_d, "g_state"),
                                         ("g", g_loss, "g_state", jb.tx_g, "d_state")):
        st = getattr(jb, state)
        grads = jax.jit(jax.grad(loss))(st.params, getattr(jb, other).params)
        updates, opt = tx.update(grads, st.opt_state, st.params)
        setattr(jb, state, st.replace(params=optax.apply_updates(st.params, updates),
                                      opt_state=opt))
        out[name] = (getattr(jb, state).params, opt[0])
    ema = jax.tree.map(lambda e, p: e * JT.EMA_DECAY + p * (1 - JT.EMA_DECAY), jb.g_ema,
                       jb.g_state.params)
    return out, ema


def _assert_close(got, want, atol, rtol=0.0):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(), atol=atol,
                                   rtol=rtol, err_msg=name)


def _moments(optim, module):
    st = {n: optim.state[p] for n, p in module.named_parameters()}
    return ({n: s["exp_avg"] for n, s in st.items()}, {n: s["exp_avg_sq"] for n, s in st.items()},
            {float(s["step"]) for s in st.values()})


def test_jax_checkpoint_resumes_in_port(tmp_path):
    path, jt = _jax_checkpoint(tmp_path)
    tr = port_trainer(tmp_path / "port", _images(), drs=True, augment_p=0.0)
    assert tr.load_ckpt(path) == 5
    assert tr.ada_aug_p == ADA_P and tr.ada.ada_aug_p == ADA_P
    assert float(tr.pl_mean) == pytest.approx(PL_MEAN)
    # restored exactly: weights, EMA, the twin D, and each net's moments
    for module, want in ((tr.gen, jax_params.generator_state_dict(jt.g_state.params)),
                         (tr.g_ema, jax_params.generator_state_dict(jt.g_ema)),
                         (tr.disc, jax_params.discriminator_state_dict(jt.d_state.params)),
                         (tr.drs_disc, jax_params.discriminator_state_dict(jt.d_drs_state.params))):
        _assert_close(module.state_dict(), want, 0.0)
    for optim, module, st, bridge in (
            (tr.g_optim, tr.gen, jt.g_state, jax_params.generator_state_dict),
            (tr.d_optim, tr.disc, jt.d_state, jax_params.discriminator_state_dict),
            (tr.drs_optim, tr.drs_disc, jt.d_drs_state, jax_params.discriminator_state_dict)):
        mu, nu, steps = _moments(optim, module)
        _assert_close(mu, bridge(st.opt_state[0].mu), 0.0)
        _assert_close(nu, bridge(st.opt_state[0].nu), 0.0)
        assert steps == {float(COUNT)}

    # one step from the resumed state, against the JAX trainer's resume
    jb = jax_trainer(tmp_path / "jax_b", _images(), drs=True, augment_p=ADA_P)
    assert jb.load_ckpt(path) == 5
    d = _injected_draws()
    want, want_ema = _jax_resumed_step(jb, d)
    fakes = TT.FakeDraws(torch.from_numpy(d["z1"]), torch.from_numpy(d["z2"]), 3,
                         [torch.from_numpy(n) for n in d["noises"]])
    tr.d_step(tr.disc, tr.d_optim, torch.from_numpy(d["real"]), fakes, None, None)
    tr.g_step(fakes, None)
    for name, module, optim, bridge in (
            ("d", tr.disc, tr.d_optim, jax_params.discriminator_state_dict),
            ("g", tr.gen, tr.g_optim, jax_params.generator_state_dict)):
        params, adam = want[name]
        _assert_close(module.state_dict(), bridge(params), PARAM_ATOL, PARAM_RTOL)
        mu, nu, steps = _moments(optim, module)
        assert steps == {float(COUNT + 1)} and int(adam.count) == COUNT + 1
        _assert_close(mu, bridge(adam.mu), MOMENT_ATOL, MOMENT_RTOL)
        _assert_close(nu, bridge(adam.nu), MOMENT_ATOL, MOMENT_RTOL)
    _assert_close(tr.g_ema.state_dict(), jax_params.generator_state_dict(want_ema), PARAM_ATOL,
                  PARAM_RTOL)


def _reference_file(tmp_path, name="000123.pt"):
    g_sd = _fabricate_sg2_g_sd()
    for j in range(2):  # the blur buffers a real reference G also saves
        g_sd[f"convs.{2 * j}.conv.blur.kernel"] = np.full((4, 4), 1 / 16, np.float32)
        g_sd[f"to_rgbs.{j}.upsample.kernel"] = np.full((4, 4), 1 / 4, np.float32)
    ema_sd = {k: v * 0.5 for k, v in g_sd.items()}
    d_sd = _fabricate_sg2_d_sd()

    def tensors(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

    path = tmp_path / name
    torch.save({"g": tensors(g_sd), "d": tensors(d_sd), "g_ema": tensors(ema_sd),
                "g_optim": {"state": {}, "param_groups": []}, "d_optim": {"state": {},
                "param_groups": []}, "ada_aug_p": 0.25}, path)
    return path, g_sd, ema_sd, d_sd


def test_reference_checkpoint_loads_exactly(tmp_path):
    """A reference {iter:06d}.pt (16 px, full width) in load_ckpt,
    read_stylegan2_ckpt and cli.generate: exactly the JAX import bridged
    through jax_params."""
    path, g_sd, ema_sd, d_sd = _reference_file(tmp_path)
    conv = TI.import_stylegan2_checkpoint(path, SIZE)
    want_g = jax_params.generator_state_dict(conv["g"])
    want_ema = jax_params.generator_state_dict(conv["g_ema"])
    want_d = jax_params.discriminator_state_dict(conv["d"])
    g = T.StyleGAN2Generator(size=SIZE, device="cpu")
    d = T.StyleGAN2Discriminator(size=SIZE, device="cpu")
    tr = TT.StyleGAN2Trainer(tmp_path / "run", g, d, _images(), num_steps=1, batch_size=BS,
                             drs_disc=T.StyleGAN2Discriminator(size=SIZE, device="cpu"),
                             device="cpu")
    assert tr.load_ckpt(path) == 123 and tr.ada_aug_p == 0.25
    for module, want in ((tr.gen, want_g), (tr.g_ema, want_ema), (tr.disc, want_d),
                         (tr.drs_disc, want_d)):
        _assert_close(module.state_dict(), want, 0.0)
    assert not tr.g_optim.state and not tr.d_optim.state  # fresh moments, as in the JAX package

    g2 = T.StyleGAN2Generator(size=SIZE, device="cpu")
    d2 = T.StyleGAN2Discriminator(size=SIZE, device="cpu")
    read_stylegan2_ckpt(path, g2, d2, use_drs=True)
    _assert_close(g2.state_dict(), want_ema, 0.0)
    _assert_close(d2.state_dict(), want_d, 0.0)
    imgs = generate.main(["--size", str(SIZE), "--sample", "2", "--pics", "1", "--ckpt",
                          str(path), "--out_dir", str(tmp_path / "samples"), "--device", "cpu"])
    assert imgs.shape == (2, SIZE, SIZE, 3) and np.isfinite(imgs).all()

    for bad in ({**g_sd, "style.1.extra": g_sd["style.1.bias"]}, {**g_sd, "convs.0.noise.w": 1}):
        with pytest.raises(ValueError, match="no rule"):
            jax_params.reference_generator_state_dict(bad)
    with pytest.raises(ValueError, match="no rule"):
        jax_params.reference_discriminator_state_dict({**d_sd, "convs.1.conv1.2.bias": 0})
