"""The port's small classifiers (diagan_tpu_torch/models/convnets.py) against
the JAX package's Flax ones, on the CPU.

The Flax variables (initialised from a seed) go through
utils/jax_params.py's bridge into the port's modules; the same numpy images
(NHWC, 16-32 px) go through both, in train mode (batch statistics, the
running statistics advanced) and in eval mode. Tolerance 1e-5 x max(1,
max|out|) on logits and features and on BatchNorm's running means after a
train forward; 5e-5 x max(1, max|var|) on the running variances, which Flax
takes in one pass as E[x^2] - E[x]^2 (float32 cancellation: 1.1e-5 seen on
AttrClassifier's second BatchNorm) and torch in two. AttrClassifier's train
mode takes the dropout mask Flax draws (recorded from jax.random.bernoulli)
as its keep mask. Also: the port's initialisers match Flax's in
distribution (truncated normal on fan-in).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diagan_tpu.models import convnets as J  # noqa: E402
from diagan_tpu_torch.models import convnets as T  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them wait on
    each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what, rel=1e-5):
    want = np.asarray(want)
    tol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol, err_msg=what)


def flax_dropout_mask(model, variables, x, key):
    """The keep mask a train-mode Flax apply with rngs={"dropout": key} draws
    (jax.random.bernoulli recorded while the apply is traced)."""
    seen = []
    bernoulli = jax.random.bernoulli

    def record(*a, **k):
        seen.append(bernoulli(*a, **k))
        return seen[-1]

    def mask(variables, x):
        model.apply(variables, x, train=True, mutable=["batch_stats"], rngs={"dropout": key})
        return seen[-1]

    jax.random.bernoulli = record
    try:
        out = np.asarray(jax.jit(mask)(variables, x))
    finally:
        jax.random.bernoulli = bernoulli
    assert len(seen) == 1
    return out


CASES = {
    "SimpleConvNet": (lambda: J.SimpleConvNet(num_labels=5),
                      lambda: T.SimpleConvNet(num_labels=5, device="cpu"),
                      jax_params.simple_convnet_state_dict, 16),
    "Simple3DNet": (lambda: J.Simple3DNet(num_labels=3),
                    lambda: T.Simple3DNet(num_labels=3, device="cpu"),
                    jax_params.simple3dnet_state_dict, 24),
    "SimpleNet": (lambda: J.SimpleNet(num_labels=4, dim=32),
                  lambda: T.SimpleNet(16 * 16 * 3, num_labels=4, dim=32, device="cpu"),
                  jax_params.simple_net_state_dict, 16),
    "AttrClassifier": (lambda: J.AttrClassifier(num_attrs=2),
                       lambda: T.AttrClassifier(num_attrs=2, device="cpu"),
                       jax_params.attr_classifier_state_dict, 32),
}


@pytest.mark.parametrize("name", list(CASES))
def test_against_flax_in_train_and_eval_mode(name):
    make_j, make_t, bridge, px = CASES[name]
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4, px, px, 3)).astype(np.float32)
    jm = make_j()
    # jitted: eager Flax is slow on the CPU
    variables = jax.device_get(jax.jit(lambda x: jm.init(
        {"params": jax.random.key(3), "dropout": jax.random.key(4)}, x, train=False))(x))
    apply_eval = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    apply_train = jax.jit(lambda v, x, key: jm.apply(v, x, train=True, mutable=["batch_stats"],
                                                     rngs={"dropout": key}))
    tm = make_t()
    tm.load_state_dict(bridge(variables))

    # eval mode: the running statistics (moved off their init first, so
    # that eval mode is told apart from train mode)
    if "batch_stats" in variables:
        variables = jax.tree_util.tree_map(
            lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32), variables)
        tm.load_state_dict(bridge(variables))
    want = apply_eval(variables, x)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for what, g, w in zip(("logits", "features"), got, want):
        _close(g.numpy(), w, f"{name} eval {what}")

    # train mode: batch statistics, running statistics advanced
    key = jax.random.key(7)
    want, new_state = apply_train(variables, x, key)
    kwargs = {}
    if name == "AttrClassifier":
        kwargs["dropout_mask"] = torch.tensor(flax_dropout_mask(jm, variables, x, key))
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), **kwargs)
    for what, g, w in zip(("logits", "features"), got, want):
        _close(g.numpy(), w, f"{name} train {what}")
    if "batch_stats" in variables:
        sd = tm.state_dict()
        want_sd = bridge({"params": variables["params"], **jax.device_get(new_state)})
        for k, v in want_sd.items():
            if "running" in k:
                _close(sd[k].numpy(), v.numpy(), f"{name} {k}",
                       rel=5e-5 if k.endswith("var") else 1e-5)
        assert all(int(sd[k]) == 1 for k in sd if k.endswith("num_batches_tracked"))


def test_dropout_scales_kept_units_by_two():
    torch.manual_seed(0)
    m = T.AttrClassifier(num_attrs=3, device="cpu").train()
    x = torch.rand((2, 16, 16, 3)) * 2 - 1
    keep = torch.zeros((2, 512), dtype=torch.bool)
    keep[:, ::3] = True
    logits, feat = m(x, dropout_mask=keep)
    h = torch.relu(m.fc1(feat))
    want = m.fc2(torch.where(keep, 2 * h, torch.zeros_like(h)))
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-6)


def test_bridge_raises_on_a_leaf_it_does_not_consume():
    variables = jax.device_get(jax.jit(J.SimpleNet(num_labels=2, dim=8).init)(
        jax.random.key(0), jnp.zeros((1, 4, 4, 3))))
    variables["params"]["Extra_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="no rule for Flax leaf"):
        jax_params.simple_net_state_dict(variables)


@pytest.mark.parametrize("layer", ["conv", "dense", "kaiming conv"])
def test_initialisers_match_flax_in_distribution(layer):
    """Flax's lecun_normal / kaiming_normal against the port's init: the same
    truncated normal (|w| <= 2 std of the untruncated draw), std within 3%."""
    torch.manual_seed(0)
    if layer == "kaiming conv":
        w = T.SimpleConvNet(device="cpu").conv3.weight.detach().numpy()
        init, shape = jax.nn.initializers.kaiming_normal(), (7, 7, 64, 128)
    elif layer == "conv":
        w = T.AttrClassifier(device="cpu").conv6.weight.detach().numpy()
        init, shape = jax.nn.initializers.lecun_normal(), (3, 3, 256, 512)
    else:
        w = T.AttrClassifier(device="cpu").fc1.weight.detach().numpy()
        init, shape = jax.nn.initializers.lecun_normal(), (512, 512)
    ref = np.asarray(init(jax.random.key(0), shape, jnp.float32))
    assert w.size == ref.size
    assert abs(w.std() / ref.std() - 1) < 0.03
    assert np.abs(w).max() <= np.abs(ref).max() * 1.01 and np.abs(w).max() > 0.95 * np.abs(ref).max()
