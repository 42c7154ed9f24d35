"""StyleGAN3-T in the port (models/stylegan3.py, ops/filtered_lrelu.py and the
CLAMP build of ops/fused_act.py) against the benchmark's plain reference
(benchmark/reference/stylegan3.py), on the CPU:

- the layer schedule at 256 px, exactly, and every filter's taps;
- filtered_lrelu at each (up, taps, pad) family of the 256 px table, the
  negative pads included, at 4 channels: forward in fp32 and fp64 and the
  gradients under autograd in fp64 (the plain twins of the kernels compute
  in fp32, as the kernels do, so fp64 agrees to fp32's round-off);
- the clamp binding on a forced input, with and without autograd;
- the whole G on one seeded state_dict at 32 px and narrow channels;
- DRS over it with a small D: every served image is the reference's image
  of its proposal, in proposal order;
- the registry's ffhq / stylegan3 bundle, its key names, the eval CLI and
  the checkpoint read; any other model on ffhq stays StyleGAN2;
- the launch arguments of the CLAMP build, and the counters and spans.
"""
import contextlib
import functools
import math

import pytest

torch = pytest.importorskip("torch")

from benchmark.reference import stylegan3 as ref  # noqa: E402
from diagan_tpu_torch.models import registry, stylegan3  # noqa: E402
from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator  # noqa: E402
from diagan_tpu_torch.ops import _build, fused_act  # noqa: E402
from diagan_tpu_torch.ops.filtered_lrelu import filtered_lrelu  # noqa: E402

# (name, in size, out size, channels, up, up taps, down, down taps, pad) at 256 px
TABLE = [
    ("L0_36_512", 36, 36, 512, 2, 12, 2, 12, (9, 8)),
    ("L1_36_512", 36, 36, 512, 2, 12, 2, 12, (9, 8)),
    ("L2_36_512", 36, 36, 512, 2, 12, 2, 12, (9, 8)),
    ("L3_52_512", 36, 52, 512, 4, 24, 2, 12, (-6, -9)),
    ("L4_52_512", 52, 52, 512, 2, 12, 2, 12, (9, 8)),
    ("L5_84_512", 52, 84, 512, 4, 24, 2, 12, (-6, -9)),
    ("L6_84_512", 84, 84, 512, 2, 12, 2, 12, (9, 8)),
    ("L7_148_512", 84, 148, 512, 4, 24, 2, 12, (-6, -9)),
    ("L8_148_512", 148, 148, 512, 2, 12, 2, 12, (9, 8)),
    ("L9_148_362", 148, 148, 362, 2, 12, 2, 12, (9, 8)),
    ("L10_276_256", 148, 276, 256, 4, 24, 2, 12, (-6, -9)),
    ("L11_276_181", 276, 276, 181, 2, 12, 2, 12, (9, 8)),
    ("L12_276_128", 276, 276, 128, 2, 12, 2, 12, (9, 8)),
    ("L13_256_128", 276, 256, 128, 2, 12, 2, 12, (-11, -12)),
    ("L14_256_3", 256, 256, 3, 1, 1, 1, 1, (0, 0)),
]
CFG = dict(img_resolution=256, z_dim=512, w_dim=512, mapping_layers=2, mapping_lr=0.01,
           num_layers=14, num_critical=2, first_cutoff=2, first_stopband=2 ** 2.1,
           last_stopband_rel=2 ** 0.3, margin_size=10, filter_size=6, lrelu_upsampling=2,
           conv_kernel=3, channel_base=32768, channel_max=512, output_scale=0.25,
           d_channel_multiplier=2)
SMALL = dict(img_resolution=32, channel_base=256, channel_max=8)
# the families of the table: (the layer whose filters and pads are used, its input size)
FAMILIES = {"up2": (0, 38), "up4_crop": (3, 38), "up2_crop": (13, 278)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def schedule():
    return stylegan3.synthesis_schedule()[1]


def test_the_schedule_at_256_is_the_published_table():
    inp, layers = stylegan3.synthesis_schedule()
    assert inp == dict(channels=512, size=36, sampling_rate=16.0, bandwidth=2.0)
    got = [(s["name"], s["in_size"], s["out_size"], s["out_channels"], s["up"], s["up_taps"],
            s["down"], s["down_taps"], s["padding"][:2]) for s in layers]
    assert got == TABLE
    assert all(s["padding"][:2] == s["padding"][2:] for s in layers)
    assert [s["in_channels"] for s in layers] == [512] + [row[3] for row in TABLE[:-1]]
    assert [s["name"] for s in ref.schedule(CFG)[0]] == [row[0] for row in TABLE]


def test_each_filter_sums_to_one_and_is_symmetric():
    for spec in schedule()[:-1]:
        for name, taps in (("up_filter", spec["up_taps"]), ("down_filter", spec["down_taps"])):
            f = stylegan3.design_lowpass_filter(
                taps, spec["in_cutoff" if name == "up_filter" else "out_cutoff"],
                2 * spec["in_half_width" if name == "up_filter" else "out_half_width"],
                spec["tmp_sampling_rate"])
            assert f.shape == (taps,)
            assert abs(float(f.double().sum()) - 1.0) < 1e-6, (spec["name"], name)
            assert torch.allclose(f, f.flip(0), rtol=0, atol=1e-7), (spec["name"], name)
    rgb = stylegan3.SynthesisLayer(schedule()[-1], device="meta")
    assert rgb.up_filter is None and rgb.down_filter is None


def _case(family, dtype, scale=1.0, seed=0):
    """(x, fu, fd, b, up, down, pad, out size) of `family` at 4 channels."""
    i, size = FAMILIES[family]
    spec = schedule()[i]
    layer = stylegan3.SynthesisLayer(spec, device="cpu")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 4, size, size), generator=g, dtype=torch.float64) * scale
    b = torch.randn(4, generator=g, dtype=torch.float64) * 0.1
    return (x.to(dtype), layer.up_filter, layer.down_filter, b.to(dtype), spec["up"],
            spec["down"], spec["padding"], spec["out_size"])


def _reference(x, fu, fd, b, up, down, pad):
    t = x + b[None, :, None, None]
    return ref.filtered_lrelu(t, fu.to(x.dtype), fd.to(x.dtype), up, down, pad[:2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_filtered_lrelu_matches_the_reference(family, dtype):
    x, fu, fd, b, up, down, pad, out = _case(family, dtype)
    with torch.no_grad():
        got = filtered_lrelu(x + b[None, :, None, None], fu, fd, up, down, pad, 256)
    want = _reference(x, fu, fd, b, up, down, pad)
    assert got.shape == (2, 4, out, out) and got.dtype == dtype
    # fp32 sums in another order (and fp64 through the fp32 plain twins)
    assert (got - want).abs().max() <= 2e-6 * want.abs().max(), family


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_filtered_lrelu_gradients_match_the_reference(family):
    x, fu, fd, b, up, down, pad, _ = _case(family, torch.float64, scale=3.0)
    out = _case(family, torch.float64)[-1]
    cot = torch.randn((2, 4, out, out), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (lambda x, b: filtered_lrelu(x + b[None, :, None, None], fu, fd, up, down, pad,
                                           4.0),
               lambda x, b: _reference(x, fu, fd, b, up, down, pad)):
        xx, bb = x.clone().requires_grad_(), b.clone().requires_grad_()
        with mock_clamp(4.0):  # the reference's bound, so that the clamp binds somewhere
            grads.append(torch.autograd.grad((fn(xx, bb) * cot).sum(), (xx, bb)))
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), family


def _ref_unclamped(x, fu, fd, b, up, down, pad):
    with mock_clamp(1e30):
        return _reference(x, fu, fd, b, up, down, pad)


@contextlib.contextmanager
def mock_clamp(value):
    old, ref.CLAMP = ref.CLAMP, value
    try:
        yield
    finally:
        ref.CLAMP = old


def test_the_clamp_binds_on_a_forced_input():
    x, fu, fd, b, up, down, pad, _ = _case("up4_crop", torch.float32, scale=400.0)
    t = x + b[None, :, None, None]
    with torch.no_grad():
        fused = filtered_lrelu(t, fu, fd, up, down, pad, 256)
    composed = filtered_lrelu(t.requires_grad_(), fu, fd, up, down, pad, 256)
    want = _reference(x.detach(), fu, fd, b, up, down, pad)
    free = _ref_unclamped(x.detach(), fu, fd, b, up, down, pad)
    assert torch.equal(fused, composed.detach())
    assert (fused - want).abs().max() <= 2e-6 * want.abs().max()
    assert (free - want).abs().max() > 100  # the clamp changed the output
    u = torch.tensor([[-1000.0, -181.0, 0.0, 181.0, 182.0, 1000.0]]).t().contiguous()
    got = fused_act.clamped_leaky_relu(u, 256.0)
    assert torch.equal(got, torch.clamp(fused_act.fused_leaky_relu_plain(u, torch.zeros(1)),
                                        -256, 256))
    assert float(got.max()) == 256.0 and float(got.min()) == -256.0


def _seeded_pair(seed=0, **size):
    """The port's G and the reference's at `size`, on one state_dict: the
    port's init, its input transform and magnitude_ema made non-trivial."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        g = stylegan3.StyleGAN3Generator(device="cpu", **size)
        with torch.no_grad():
            g.synthesis.input.affine.weight.normal_(0, 0.3)
            for name in g.synthesis.layer_names:
                getattr(g.synthesis, name).magnitude_ema.uniform_(0.5, 2.0)
                getattr(g.synthesis, name).bias.normal_(0, 0.1)
    r = ref.Generator(dict(CFG, **size), device="cpu")
    missing, unexpected = r.load_state_dict(g.state_dict(), strict=False)
    assert not missing and not unexpected
    return g.eval(), r.eval()


def test_the_generator_matches_the_reference():
    g, r = _seeded_pair(**SMALL)
    z = torch.randn((3, 512), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, want = g(z), r(z)
    assert got.shape == (3, 32, 32, 3)
    assert float(want.std()) > 1e-2
    assert (got - want).abs().max() <= 1e-5 * max(1.0, float(want.abs().max()))


def test_drs_serves_the_reference_images_in_order():
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.evaluate import make_disc_fn, make_gen_fn
    g, r = _seeded_pair(seed=3, **SMALL)
    with torch.random.fork_rng():
        torch.manual_seed(4)
        d = StyleGAN2Discriminator(32, width_scale=1 / 32, device="cpu")
    zs = []
    gen = make_gen_fn(g)

    def gen_fn(z):
        zs.append(z)
        return gen(z)

    drs = DRS(gen_fn, make_disc_fn(d), 512, generator=torch.Generator().manual_seed(5),
              batch_size=8, warmup_batches=2, device="cpu")
    served = torch.from_numpy(drs.generate_images(6))
    with torch.no_grad():
        want = torch.cat([r(z) for z in zs[2:]])
    last = -1
    for img in served:
        err = (want - img).flatten(1).abs().max(1).values
        j = int(err.argmin())
        assert float(err[j]) <= 1e-5 and j > last
        last = j


def _narrow(monkeypatch):
    monkeypatch.setattr(registry, "_STYLEGAN3_G",
                        functools.partial(stylegan3.StyleGAN3Generator, channel_base=256,
                                          channel_max=8))
    monkeypatch.setattr(registry, "_STYLEGAN2_D",
                        functools.partial(StyleGAN2Discriminator, width_scale=1 / 32))


def test_the_registry_bundle_and_its_key_names():
    b = registry.get_gan_model("ffhq", model="stylegan3", drs=True, device="cpu")
    assert (b.model, b.nz, b.image_size) == ("stylegan3", 512, 256)
    assert isinstance(b.gen, stylegan3.StyleGAN3Generator)
    assert isinstance(b.disc, StyleGAN2Discriminator)
    assert isinstance(b.disc_drs, StyleGAN2Discriminator)
    keys = set(b.gen.state_dict())
    assert {"mapping.fc0.weight", "mapping.fc1.bias", "mapping.w_avg", "synthesis.input.weight",
            "synthesis.input.affine.weight", "synthesis.input.freqs", "synthesis.input.phases",
            "synthesis.input.transform"} <= keys
    for name, *_ in TABLE:
        fields = {"weight", "bias", "affine.weight", "affine.bias", "magnitude_ema"}
        if name != "L14_256_3":
            fields |= {"up_filter", "down_filter"}
        assert {k for k in keys if k.startswith(f"synthesis.{name}.")} == \
            {f"synthesis.{name}.{f}" for f in fields}
    assert len(keys) == 5 + 6 + 14 * 7 + 5  # mapping, input, L0-L13, ToRGB
    for model in ("sngan", "stylegan"):
        b = registry.get_gan_model("ffhq", model=model, device="cpu", size=32)
        assert b.model == "stylegan" and not isinstance(b.gen, stylegan3.StyleGAN3Generator)
    with pytest.raises(ValueError, match="float32"):
        registry.get_gan_model("ffhq", model="stylegan3", device="cpu", bf16=True)


def test_the_eval_cli_and_the_checkpoint_read(tmp_path, monkeypatch):
    from diagan_tpu_torch.cli import eval_gan_drs
    from diagan_tpu_torch.eval import evaluate
    _narrow(monkeypatch)
    monkeypatch.setattr(eval_gan_drs, "evaluate_fid_is_pr", lambda args, bundle, *a, **k: bundle)
    b = eval_gan_drs.main(["-d", "ffhq", "--model", "stylegan3", "--netG_ckpt_step", "3",
                           "--device", "cpu"])
    assert b.model == "stylegan3" and isinstance(b.gen, stylegan3.StyleGAN3Generator)
    src = registry.get_gan_model("ffhq", model="stylegan3", drs=True, device="cpu")
    (tmp_path / "checkpoint").mkdir()
    evaluate.save_stylegan2_ckpt(tmp_path / "checkpoint" / "000003.pt", src.gen, src.disc,
                                 src.disc_drs)
    gen, disc = evaluate.load_eval_models(b, tmp_path, 3, use_drs=True)
    for got, want in ((gen, src.gen), (disc, src.disc_drs)):
        assert all(torch.equal(got.state_dict()[k], v) for k, v in want.state_dict().items())


class _Kernel:
    def __init__(self):
        self.launches = []

    def __getitem__(self, grid):
        return lambda *args, **kw: self.launches.append((grid, args, kw))


def test_the_clamp_build_launch(monkeypatch):
    """clamped_leaky_relu launches flr_fwd with CLAMP on, a zero bias, its
    bound and the default build, counted apart; it refuses a graph."""
    kernel = _Kernel()
    monkeypatch.setattr(fused_act, "_kernels", lambda: (kernel, None, None))
    monkeypatch.setattr(fused_act, "_on", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    x = torch.randn((2, 4, 3, 5))
    fused_act.clamped_leaky_relu(x, 256)
    ((grid, args, kw),) = kernel.launches
    assert grid == (1,) and torch.equal(args[1], torch.zeros(4))
    assert args[6:] == (x.numel(), 15, 4, 0.2, math.sqrt(2.0), 256.0)
    assert kw == {"STYLED": False, "CLAMP": True, "BLOCK": 1024, "num_warps": 4}
    assert _build.LAUNCHES["clamped_leaky_relu"] == 1 and _build.LAUNCHES["fused_leaky_relu"] == 0
    with pytest.raises(RuntimeError, match="autograd off"):
        fused_act.clamped_leaky_relu(x.requires_grad_(), 256)


def test_counters_and_spans():
    from diagan_tpu_torch.utils import trace
    g, _ = _seeded_pair(**SMALL)
    z = torch.randn((2, 512))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            g(z)
        g(z)
    assert trace.counters() == {"filtered_lrelu": 28, "filtered_lrelu_fused": 14}
    assert [s[2] for s in trace.spans()] == ["g.filtered_lrelu"] * 28
