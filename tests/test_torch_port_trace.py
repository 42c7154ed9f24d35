"""The port's spans and counters (diagan_tpu_torch/utils/trace.py) in the
StyleGAN2 trainer and the DRS sampler, on the CPU:
- outside a profiler session nothing is recorded and `span` hands back one
  shared null context;
- under torch.profiler, one d_reg_every period of a stream-mode phase-2 step
  with ADA live gives the span tree of the module docstrings: one main D,
  twin D and G phase a step, two R1 phases on the R1 step, a path phase on
  each g_reg_every step, every augment inside a phase, the gather and the
  slot wait inside the data draw, one host_sync a step, every child inside
  its parent;
- recording changes nothing: losses and weights after two steps are
  bit-equal with it on and off, and so are DRS's images;
- DRS records its four spans a batch, its concatenate once a request, and
  a host_sync for each of its reads;
- a second session starts empty.
Small models: 16 px, width 1/16, style_dim 32, n_mlp 2, batch 4, a period of
4 steps with path every 2; torch's own seeded init, no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diagan_tpu_torch.eval.drs import DRS  # noqa: E402
from diagan_tpu_torch.models import stylegan2 as T  # noqa: E402
from diagan_tpu_torch.train import stylegan2_trainer as TT  # noqa: E402
from diagan_tpu_torch.utils import trace  # noqa: E402

SIZE, BS, STYLE_DIM, N_MLP, WIDTH = 16, 4, 32, 2, 1 / 16
D_REG, G_REG = 4, 2
PHASES = ("train.d_main", "train.d_twin", "train.r1", "train.g", "train.path")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


class _Done:
    """A copy's event that has completed (the CPU staging keeps none)."""

    def synchronize(self):
        pass


def trainer(tmp_path):
    """A stream-mode phase-2 trainer with the twin D, weighted reals and ADA
    adaptive from p 0.05 (it moves after 256 images, so it stays put here)."""
    torch.manual_seed(0)
    kw = dict(size=SIZE, width_scale=WIDTH, device="cpu")
    gen = T.StyleGAN2Generator(style_dim=STYLE_DIM, n_mlp=N_MLP, **kw)
    disc, drs = T.StyleGAN2Discriminator(**kw), T.StyleGAN2Discriminator(**kw)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (40, SIZE, SIZE, 3), np.uint8)
    tr = TT.StyleGAN2Trainer(tmp_path, gen, disc, images, num_steps=8, drs_disc=drs,
                             sample_weights=rng.random(40) + 0.5, batch_size=BS,
                             d_reg_every=D_REG, g_reg_every=G_REG, augment_p=0.0,
                             stream_data=True, seed=3, device="cpu")
    tr.ada_aug_p = tr.ada.ada_aug_p = 0.05
    tr._staging.events = [_Done()] * len(tr._staging.events)
    return tr


def steps(tr, n, start=0):
    out = []
    for t in range(start, start + n):
        m = tr.train_step(t)
        tr.tune_ada(m)
        out.append({k: v.clone() for k, v in m.items()})
    return out


def names(spans):
    return [s[2] for s in spans]


def test_nothing_is_recorded_outside_a_session(tmp_path):
    assert trace.span("a") is trace.span("b")
    assert trace.span("a", torch.device("cpu")) is trace.span("b")
    before, counts = trace.spans(), trace.counters()
    tr = trainer(tmp_path)
    steps(tr, 1)
    trace.count("host_sync")
    assert trace.spans() == before and trace.counters() == counts


def test_one_period_gives_the_span_tree(tmp_path):
    tr = trainer(tmp_path)
    with profiled():
        steps(tr, D_REG)
    spans = trace.spans()
    by = names(spans)
    assert by.count("train.d_main") == by.count("train.d_twin") == by.count("train.g") == D_REG
    assert by.count("train.r1") == 2  # both Ds, on step 0 alone
    assert by.count("train.path") == D_REG // G_REG
    assert by.count("train.tune_ada") == D_REG
    assert trace.counters() == {"host_sync": D_REG}
    # reals: main and twin D a step, both Ds again for R1; each gathered
    n_draws = 2 * D_REG + 2
    assert by.count("data.draw") == by.count("data.gather") == by.count("data.staging_wait") \
        == n_draws
    # ADA: reals and fakes of both D steps, R1's reals twice, G's fakes
    assert by.count("ada.augment") == by.count("ada.draw") == 5 * D_REG + 2
    assert trace.device_ms() == {}  # no CUDA stream: host spans alone
    for i, (s, e, name, parent) in enumerate(spans):
        assert e is not None and s <= e
        up = spans[parent] if parent is not None else None
        if up is not None:
            assert up[0] <= s and e <= up[1], (name, up[2])
        if name == "ada.augment":
            assert up is not None and up[2] in PHASES
        elif name in ("data.gather", "data.staging_wait"):
            assert up is not None and up[2] == "data.draw"
        elif name in PHASES or name in ("data.draw", "ada.draw", "train.tune_ada"):
            assert up is None, name
        else:
            assert name == "train.draw", name
            assert up is None or up[2] == "train.draw"
    order = [n for n in by if n in PHASES]
    assert order[:5] == ["train.d_main", "train.d_twin", "train.r1", "train.r1", "train.g"]
    assert order[5:8] == ["train.path", "train.d_main", "train.d_twin"]


def test_recording_changes_no_loss_and_no_weight(tmp_path):
    off, on = trainer(tmp_path / "off"), trainer(tmp_path / "on")
    m_off = steps(off, 2)
    with profiled():
        m_on = steps(on, 2)
    assert len(trace.spans()) > 0
    for a, b in zip(m_off, m_on):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for name in ("gen", "disc", "drs_disc", "g_ema"):
        pa, pb = getattr(off, name).state_dict(), getattr(on, name).state_dict()
        for k in pa:
            assert torch.equal(pa[k], pb[k]), (name, k)
    assert off.ada_aug_p == on.ada_aug_p


def sampler(batch=8):
    """A DRS over tiny closures, and the list of its accepted count at each
    call of D (so the count of each batch is a difference of two)."""
    w = torch.linspace(-1.0, 1.0, 4 * 4 * 3 * 6).reshape(6, 4 * 4 * 3)
    seen, box = [], {}

    def gen_fn(z):
        return torch.tanh(z @ w).reshape(-1, 4, 4, 3)

    def disc_fn(x):
        seen.append(box["drs"].accepted if "drs" in box else 0)
        return 3.0 * x.mean((1, 2, 3))

    box["drs"] = DRS(gen_fn, disc_fn, 6, generator=torch.Generator().manual_seed(5),
                     batch_size=batch, warmup_batches=2, device="cpu")
    return box["drs"], seen


def request(s, seen, n):
    """(images, batches, host reads expected): the max and the count each
    batch, the images each batch that accepted any."""
    b0 = len(seen)
    out = s.generate_images(n, return_uint8=True)
    acc = seen[b0:] + [s.accepted]
    batches = len(acc) - 1
    return out, batches, 2 * batches + sum(b > a for a, b in zip(acc, acc[1:]))


def test_drs_spans_a_batch_and_the_same_images():
    want = request(*sampler(), 20)[0]
    s, seen = sampler()
    with profiled():
        got, batches, syncs = request(s, seen, 20)
    np.testing.assert_array_equal(got, want)
    spans = trace.spans()
    by = names(spans)
    assert batches >= 3
    for n in ("drs.generate", "drs.discriminate", "drs.select", "drs.collect"):
        assert by.count(n) == batches, n
    assert by.count("drs.concat") == 1 and by[-1] == "drs.concat"
    assert by[:4] == ["drs.generate", "drs.discriminate", "drs.select", "drs.collect"]
    assert all(p is None for *_, p in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # one after another
    assert trace.counters() == {"host_sync": syncs}


def test_a_second_session_starts_empty():
    s, seen = sampler()
    with profiled():
        request(s, seen, 30)
    assert names(trace.spans()).count("drs.concat") == 1
    with profiled():
        _, batches, syncs = request(s, seen, 10)
    by = names(trace.spans())
    assert by.count("drs.concat") == 1 and by.count("drs.generate") == batches
    assert by[0] == "drs.generate"
    assert trace.counters() == {"host_sync": syncs}
