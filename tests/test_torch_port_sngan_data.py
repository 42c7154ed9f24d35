"""The port's SNGAN-path data, losses, logit recorder and scores against the
JAX package.

  - the copied data modules (synthetic generators, the CIFAR-10 loader on a
    tiny cifar-10-batches-py written here, ArrayDataset, get_predefined_dataset)
    byte for byte;
  - DeviceDataSource.gather exactly (the same fp32 dequantize); the weighted
    draws by their distribution (the RNGs differ, so never by seed);
  - the SNGAN losses, GOLD's weights and top-k against diagan_tpu's at rtol
    1e-6 (the losses' values and their gradients in the logits);
  - a logit sweep row against the JAX recorder's on the same D at 1e-5 x
    max(1, max|logit|); the pickle's layout ({python int: np.float64[N]},
    the same bytes as the JAX recorder's on equal values), and the JAX
    package's calculate_scores and the port's giving the same dict from it.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_port_sngan_models import jax_discriminator, port_discriminator  # noqa: E402

from diagan_tpu.data import arrays as JA  # noqa: E402
from diagan_tpu.data import pipeline as JP  # noqa: E402
from diagan_tpu.data import predefined as JPD  # noqa: E402
from diagan_tpu.data import sources as JSRC  # noqa: E402
from diagan_tpu.data import synthetic as JSYN  # noqa: E402
from diagan_tpu.models import losses as JL  # noqa: E402
from diagan_tpu.score import calculate_scores as jax_calculate_scores  # noqa: E402
from diagan_tpu.train import steps as JS  # noqa: E402
from diagan_tpu.train.logit_recorder import LogitRecorder as JaxRecorder  # noqa: E402
from diagan_tpu_torch.data import arrays as TA  # noqa: E402
from diagan_tpu_torch.data import predefined as TPD  # noqa: E402
from diagan_tpu_torch.data import sources as TSRC  # noqa: E402
from diagan_tpu_torch.data import synthetic as TSYN  # noqa: E402
from diagan_tpu_torch.data.pipeline import DeviceDataSource  # noqa: E402
from diagan_tpu_torch.models import losses as TL  # noqa: E402
from diagan_tpu_torch.score import calculate_scores  # noqa: E402
from diagan_tpu_torch.train.logit_recorder import LogitRecorder  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: the suite runs test files
    in parallel processes, and torch's default of one thread per core makes
    the processes' small ops wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_cifar_batches(root, images, labels=None):
    """images uint8 (N, 32, 32, 3) -> root/cifar-10-batches-py/data_batch_{1..5}
    (and test_batch, the first 10), in CIFAR-10's python pickle format."""
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True, exist_ok=True)
    labels = np.zeros(len(images), np.int64) if labels is None else labels
    chunks = np.array_split(np.arange(len(images)), 5)
    for name, idx in [(f"data_batch_{b + 1}", c) for b, c in enumerate(chunks)] + [
            ("test_batch", np.arange(10))]:
        rows = images[idx].transpose(0, 3, 1, 2).reshape(len(idx), -1)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rows, b"labels": [int(v) for v in labels[idx]]}, f)
    return root


# --- the copied data modules ----------------------------------------------------

@pytest.mark.parametrize("name,args", [("synthetic_mnist", (12,)), ("synthetic_fmnist", (12,)),
                                       ("synthetic_natural", (5, 32))])
def test_synthetic_generators_match_jax(name, args):
    ours, theirs = getattr(TSYN, name)(*args), getattr(JSYN, name)(*args)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_cifar10_matches_jax(tmp_path):
    images = TSYN.synthetic_natural(23, 32, seed=4)[0]
    labels = np.random.default_rng(0).integers(0, 10, 23)
    write_cifar_batches(tmp_path, images, labels)
    for train in (True, False):
        ours, theirs = TSRC.load_cifar10(tmp_path, train=train), JSRC.load_cifar10(tmp_path, train=train)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TSRC.load_cifar10(tmp_path)[0], images)
    empty = tmp_path / "none"  # the procedural fallback
    for a, b in zip(TSRC.load_cifar10(empty, fallback_n=4), JSRC.load_cifar10(empty, fallback_n=4)):
        np.testing.assert_array_equal(a, b)


def test_array_dataset_and_predefined_cifar10_match_jax(tmp_path):
    images = TSYN.synthetic_natural(10, 32, seed=6)[0]
    write_cifar_batches(tmp_path, images)
    ours = TPD.get_predefined_dataset("cifar10", tmp_path, weights=np.arange(10.0))
    theirs = JPD.get_predefined_dataset("cifar10", tmp_path, weights=np.arange(10.0))
    for field in ("images", "targets", "labels", "weights"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours.name == theirs.name and len(ours) == len(theirs) == 10
    assert ours.image_shape == theirs.image_shape
    a = TA.ArrayDataset.from_images(images[:3], targets=[1, 2, 3])
    b = JA.ArrayDataset.from_images(images[:3], targets=[1, 2, 3])
    assert a.targets.dtype == b.targets.dtype and a.targets.tolist() == b.targets.tolist()
    with pytest.raises(ValueError, match="unknown dataset"):
        TPD.get_predefined_dataset("imagenet", tmp_path)


def test_gather_matches_jax_exactly():
    images = TSYN.synthetic_natural(12, 32, seed=1)[0]
    idx = np.array([3, 0, 11, 3, 7])
    ours = DeviceDataSource(TA.ArrayDataset.from_images(images), device="cpu").gather(
        torch.from_numpy(idx))
    theirs = JP.DeviceDataSource(JA.ArrayDataset.from_images(images)).gather(jnp.asarray(idx))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_weighted_draws_follow_the_floored_weights():
    """Phase 2's weighted draws with replacement follow the eps-floored
    weights, as the JAX sampler's categorical over log-weights does; without
    weights the draws are uniform."""
    w = np.array([1.0, 3.0, 0.0, -1.0, 2.0])
    ds = TA.ArrayDataset.from_images(np.zeros((5, 2, 2, 3), np.uint8))
    src = DeviceDataSource(ds, weights=w, eps=1e-6, device="cpu")
    n = 50000
    freq = np.bincount(src.sample_indices(n, torch.Generator().manual_seed(0)).numpy(),
                       minlength=5) / n
    p = np.maximum(w, 1e-6) / np.maximum(w, 1e-6).sum()
    assert np.all(np.abs(freq - p) < 4 * np.sqrt(p * (1 - p) / n) + 1e-4)
    uni = DeviceDataSource(ds, device="cpu")
    u = np.bincount(uni.sample_indices(n, torch.Generator().manual_seed(1)).numpy(), minlength=5) / n
    assert np.all(np.abs(u - 0.2) < 4 * np.sqrt(0.16 / n))


# --- losses ---------------------------------------------------------------------

def _logits(seed, n=8):
    return np.random.default_rng(seed).normal(0, 1.5, n).astype(np.float32)


def _both(fn_t, fn_j, *arrays):
    """Value and gradient in the arrays, port and JAX."""
    ts = [torch.from_numpy(a).double().requires_grad_(True) for a in arrays]
    vt = fn_t(*ts)
    gt = torch.autograd.grad(vt, ts)
    vj, gj = jax.value_and_grad(lambda *a: fn_j(*a), argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-6)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("gold", [False, True], ids=["plain", "gold"])
@pytest.mark.parametrize("loss_type", ["hinge", "ns", "minimax", "wasserstein"])
def test_d_loss_matches_jax(loss_type, gold):
    cfg = JS.StepConfig(n_dis=1, batch_size=8, nz=1, loss_type=loss_type, drs_loss_type="ns",
                        model="sngan", gold=gold, gold_step=0, topk=False, epoch_steps=1,
                        use_drs=False, quantized=True)
    _both(lambda r, f: TL.d_loss(loss_type, r, f, gold=gold),
          lambda r, f: JS._d_loss(cfg, loss_type, r, f, jnp.asarray(True)),
          _logits(0), _logits(1))


@pytest.mark.parametrize("loss_type", ["hinge", "ns", "minimax", "wasserstein"])
def test_g_loss_and_topk_match_jax(loss_type):
    _both(lambda f: TL.g_loss(loss_type, f), JL.GEN_LOSSES[loss_type], _logits(2))
    for step, epoch_steps in ((0, 3), (7, 3), (10**6, 1)):
        rate = TL.topk_rate_at(step, epoch_steps)
        np.testing.assert_allclose(rate, float(JL.topk_rate_at(step, epoch_steps)), rtol=1e-6)
        _both(lambda f: TL.masked_gen_loss(loss_type, *TL.topk_filter(f, rate)),
              lambda f: JL.masked_gen_loss(loss_type, *JL.topk_filter(f, rate)), _logits(3))
    _, mask = TL.topk_filter(torch.from_numpy(_logits(4)), TL.topk_rate_at(7, 3))
    assert mask.tolist() == np.asarray(JL.topk_filter(_logits(4), JL.topk_rate_at(7, 3))[1]).tolist()


# --- the logit recorder and the scores -----------------------------------------

N_SWEEP, SWEEP_BS = 21, 8  # a ragged last batch


def _jax_record(disc, v, images, steps):
    rec = JaxRecorder(N_SWEEP, len(steps), batch_size=SWEEP_BS)

    def fwd(params, state, batch, rng):
        out = disc.apply({"params": params, **state}, batch, update_stats=False, train=False)
        return out, state

    for s in steps:
        rec.record(fwd, v["params"], {"spectral": v["spectral"]}, jnp.asarray(images), s)
    return rec


def test_logit_sweep_pickle_and_scores_match_jax(tmp_path):
    disc, v = jax_discriminator("32")
    images = TSYN.synthetic_natural(N_SWEEP, 32, seed=8)[0]
    steps = [100, 200, 300]
    theirs = _jax_record(disc, v, images, steps[:1])
    d = port_discriminator("32", v)
    u0 = {k: t.clone() for k, t in d.state_dict().items() if k.endswith("weight_u")}
    source = DeviceDataSource(TA.ArrayDataset.from_images(images), device="cpu")
    ours = LogitRecorder(N_SWEEP, len(steps), batch_size=SWEEP_BS, device="cpu")
    ours.record(d, source, steps[0])
    want = np.asarray(theirs.buffer[0])
    np.testing.assert_allclose(ours.buffer[0].numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
    assert all(torch.equal(t, d.state_dict()[k]) for k, t in u0.items())  # the sweep moves no u
    assert d.training  # the sweep restores the module's mode

    # two more snapshots, with D's weights moved in between
    for s in steps[1:]:
        with torch.no_grad():
            d.l5.weight.add_(0.1 * torch.randn(d.l5.weight.shape, generator=torch.Generator().manual_seed(s)))
        ours.record(d, source, s)
    got = ours.as_dict()
    assert list(got) == steps and all(type(k) is int for k in got)
    assert all(a.dtype == np.float64 and a.shape == (N_SWEEP,) for a in got.values())
    ours.save(tmp_path / "logits_netD_eval.pkl")
    with open(tmp_path / "logits_netD_eval.pkl", "rb") as f:
        loaded = pickle.load(f)
    # the JAX recorder holding the same values pickles the same bytes
    jrec = JaxRecorder(N_SWEEP, len(steps), batch_size=SWEEP_BS)
    jrec.load_state_dict(ours.state_dict())
    assert pickle.dumps(jrec.as_dict()) == pickle.dumps(loaded) == pickle.dumps(got)
    back = LogitRecorder(N_SWEEP, len(steps), device="cpu")
    back.load_state_dict(jrec.state_dict())
    assert back.count == 3 and torch.equal(back.buffer, ours.buffer)

    s_ours = calculate_scores(loaded, start_epoch=0, end_epoch=300)
    s_theirs = jax_calculate_scores(loaded, start_epoch=0, end_epoch=300)
    assert sorted(s_ours) == sorted(s_theirs) and "ldr_conf_1.0_ratio_50" in s_ours
    for key in s_theirs:
        np.testing.assert_array_equal(np.asarray(s_ours[key]), np.asarray(s_theirs[key]),
                                      err_msg=key)
