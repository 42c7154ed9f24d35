"""The port's classifier training (diagan_tpu_torch/train/classifier.py)
against the JAX package's, on the CPU.

multistep_lr equals optax's schedule as the JAX package builds it at every
step, the collapsed boundaries (epochs 1 and 2) included. train_classifier
runs 2 epochs of AttrClassifier on 32 images of 16 px at batch 8 (softmax CE
on 2 classes, and multilabel BCE on 5 attributes) from the Flax
initialisation of the JAX run (bridged), with the dropout mask that run
draws once and holds for every step; the same numpy permutations order the
batches in both. The first step's gradients agree within 1e-5 x max(1,
max|g|), taken in float64 on both sides (in float32 a BatchNorm output within
round-off of zero takes a different side of its ReLU in each package, which
moves conv0's gradient by ~1e-3 of its max). The parameters are held by
Adam's own bound: an Adam step moves a parameter by about lr whatever the
gradient's size, so a gradient that is
zero up to float32 round-off takes a different walk in each package. The
conv biases are such (each feeds a train-mode BatchNorm, which removes
them), and they shift the running means. So: every parameter within 2 x the
summed lr, and at most 5% of each other tensor's entries beyond a tenth of
it; the running statistics within 2e-3 x max(1, max|.|). The history's
accuracies agree within 1e-4 and its mean losses within 1% (the walks
above move them by 0.1-0.6% here).
predict_classifier pads a ragged last batch and equals one eval forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_convnets import flax_dropout_mask  # noqa: E402

from diagan_tpu.models import convnets as J  # noqa: E402
from diagan_tpu.train import classifier as JC  # noqa: E402
from diagan_tpu_torch.models import convnets as T  # noqa: E402
from diagan_tpu_torch.train import classifier as TC  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch (see test_torch_port_convnets.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("epochs", [1, 2, 3, 7, 80])
def test_multistep_lr_equals_optax_at_every_step(epochs):
    spe = 3
    want = JC.multistep_lr(1e-3, epochs, spe)
    got = TC.multistep_lr(1e-3, epochs, spe)
    steps = np.arange(epochs * spe + 2)
    np.testing.assert_array_equal(np.float32([got(int(s)) for s in steps]),
                                  np.asarray([want(s) for s in steps], np.float32))
    if epochs == 1:  # both boundaries 0: one decay, from step 0
        assert got(0) == float(np.float32(np.float32(1e-3) * np.float32(0.1)))


def test_the_schedule_applies_each_scale_from_its_boundary_on():
    sched = optax.piecewise_constant_schedule(1e-3, {2: 0.1, 4: 0.1})
    want = [float(sched(s)) for s in range(6)]
    f32 = np.float32
    assert np.allclose(want, [1e-3, 1e-3, 1e-4, 1e-4, 1e-5, 1e-5], rtol=1e-6)
    port = TC.multistep_lr(1e-3, 7, 1)  # boundaries 3 and 6
    lr1, lr2 = f32(f32(1e-3) * f32(0.1)), f32(f32(f32(1e-3) * f32(0.1)) * f32(0.1))
    assert [port(s) for s in range(8)] == [float(v) for v in (f32(1e-3),) * 3 + (lr1,) * 3
                                           + (lr2,) * 2]


@pytest.mark.parametrize("multilabel", [False, True], ids=["ce", "bce"])
def test_train_classifier_against_the_jax_package(multilabel):
    seed, bs, n, px = 1, 8, 32, 16
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (n, px, px, 3)).astype(np.uint8)
    if multilabel:
        num, labels = 5, np.where(rng.random((n, 5)) < 0.4, 1, -1).astype(np.int64)
    else:
        num, labels = 2, rng.integers(0, 2, n).astype(np.int64)
    jm = J.AttrClassifier(num_attrs=num)
    params, state, want_hist = JC.train_classifier(jm, images, labels, epochs=2, batch_size=bs,
                                                   seed=seed, multilabel=multilabel)

    # the JAX run's initialisation and its one dropout mask
    init = jax.device_get(jax.jit(lambda x: jm.init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)}, x,
        train=True))(jnp.zeros((2, px, px, 3))))
    x0 = images[:bs].astype(np.float32) / 127.5 - 1
    mask = flax_dropout_mask(jm, init, x0, jax.random.key(seed + 2))
    tm = T.AttrClassifier(num_attrs=num, device="cpu")
    tm.load_state_dict(jax_params.attr_classifier_state_dict(init))
    tm, got_hist = TC.train_classifier(tm, images, labels, epochs=2, batch_size=bs, seed=seed,
                                       multilabel=multilabel, dropout_mask=torch.tensor(mask))

    # the first step's gradients, from the same weights, batch and mask, in
    # float64 on both sides: in float32 a BatchNorm output within round-off
    # of 0 takes a different side of the next ReLU in each package
    idx = np.random.default_rng(seed).permutation(n)[:bs]
    x = images[idx].astype(np.float64) / 127.5 - 1.0

    def jax_loss(p):
        logits = jm.apply({"params": p, "batch_stats": init["batch_stats"]}, x, train=True,
                          mutable=["batch_stats"], rngs={"dropout": jax.random.key(seed + 2)})[0][0]
        if multilabel:
            return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, (labels[idx] > 0) * 1.0))
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, labels[idx]))

    bernoulli = jax.random.bernoulli
    jax.random.bernoulli = lambda *a, **k: jnp.asarray(mask)  # x64 would draw another
    try:
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), init["params"])
            want_g = jax_params.attr_classifier_state_dict(
                {"params": jax.device_get(jax.jit(jax.grad(jax_loss))(p64)),
                 "batch_stats": init["batch_stats"]})
    finally:
        jax.random.bernoulli = bernoulli
    probe = T.AttrClassifier(num_attrs=num, device="cpu")
    probe.load_state_dict(jax_params.attr_classifier_state_dict(init))
    probe.double()
    loss, _ = TC._loss_and_acc(probe.train()(torch.from_numpy(x), torch.tensor(mask))[0],
                               torch.from_numpy(labels[idx]), multilabel)
    loss.backward()
    for k, p in probe.named_parameters():
        w = want_g[k].double()
        assert (p.grad - w).abs().max().item() <= 1e-5 * max(1.0, w.abs().max().item()), k

    # after the 8 steps
    total_lr = sum(TC.multistep_lr(1e-3, 2, n // bs)(s) for s in range(8))
    want_sd = jax_params.attr_classifier_state_dict(
        {"params": jax.device_get(params), **jax.device_get(state)})
    got_sd = tm.state_dict()
    for k, w in want_sd.items():
        d = (got_sd[k] - w).abs()
        if k.endswith("num_batches_tracked"):
            assert int(got_sd[k]) == 8
        elif "running" in k:
            assert d.max().item() <= 2e-3 * max(1.0, w.abs().max().item()), k
        else:
            assert d.max().item() <= 2 * total_lr, k
            if not (k.startswith("conv") and k.endswith("bias")):
                assert (d > 0.1 * total_lr).float().mean().item() <= 0.05, k
    assert [h["epoch"] for h in got_hist] == [h["epoch"] for h in want_hist] == [1, 2]
    for g, w in zip(got_hist, want_hist):
        assert abs(g["loss"] - w["loss"]) <= 1e-2 * w["loss"], (g, w)
        assert abs(g["acc"] - w["acc"]) <= 1e-4, (g, w)


def test_train_classifier_writes_checkpoints_and_reuses_one_mask(tmp_path):
    torch.manual_seed(0)
    m = T.AttrClassifier(num_attrs=2, device="cpu")
    masks = []
    forward = m.forward

    def spy(x, dropout_mask=None):
        masks.append(dropout_mask)
        return forward(x, dropout_mask=dropout_mask)

    m.forward = spy
    images = np.random.default_rng(1).integers(0, 256, (20, 16, 16, 3)).astype(np.uint8)
    _, hist = TC.train_classifier(m, images, np.arange(20) % 2, epochs=2, batch_size=8,
                                  ckpt_path=tmp_path / "ck", ckpt_every=1)
    assert len(masks) == 4 and all(mk is masks[0] for mk in masks) and masks[0].shape == (8, 512)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["ckpt_1.pt", "ckpt_2.pt"]
    sd = torch.load(tmp_path / "ck" / "ckpt_2.pt", weights_only=True)
    assert all(torch.equal(sd[k], v) for k, v in m.state_dict().items())


def test_predict_classifier_pads_a_ragged_last_batch():
    torch.manual_seed(0)
    m = T.AttrClassifier(num_attrs=3, device="cpu")
    images = np.random.default_rng(2).integers(0, 256, (11, 16, 16, 3)).astype(np.uint8)
    got = TC.predict_classifier(m, images, batch_size=4)
    assert got.shape == (11, 3) and not m.training
    with torch.no_grad():
        want = m(torch.from_numpy(images).float() / 127.5 - 1)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
