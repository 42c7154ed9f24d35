"""G's StyledConv epilogue with autograd off (models/stylegan2.py StyledConv,
ops/fused_act.py styled_leaky_relu and `flr_fwd`'s STYLED flag)
against the composition it replaces.

On the CPU:
- a StyledConv under no_grad, plain and upsampling, in fp32 and bf16, with
  a given noise and with one drawn from a generator, equals the three-step
  composition of the parent formulation (written out below) bit for bit,
  and leaves the generator where the composition leaves it;
- a whole `StyleGAN2Generator.sample` likewise, images and generator state;
- under autograd the G step and the path step (double backward) take the
  composition: outputs and every gradient equal the parent formulation's;
- D, the mapping net and SNGAN never take the epilogue, and the plain
  bias-act launch keeps its parent's kernel arguments and build options.
On the card, chip_smoke.py holds `flr_fwd`'s STYLED build against the plain
version at the 256 px StyledConv shapes, times it, and compares G's 256 px
images fused and composed.
Small models on the CPU: 16 px, width 1/16, style_dim 32, n_mlp 2, batch 4.
"""
import contextlib
import math

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from diagan_tpu_torch.models import losses  # noqa: E402
from diagan_tpu_torch.models import sngan  # noqa: E402
from diagan_tpu_torch.models import stylegan2 as T  # noqa: E402
from diagan_tpu_torch.ops import _build, fused_act  # noqa: E402

SIZE, STYLE_DIM, N_MLP, WIDTH, BS = 16, 32, 2, 1 / 16, 4
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# the parent formulation: ModulatedConv applies demod itself, NoiseInjection
# adds w * noise, then the bias-act, each a pass of its own


def parent_modulated_conv(conv, x, style):
    s = conv.modulation(style).float()
    w = conv.weight * conv.scale
    if conv.demodulate:
        sigma = (s**2) @ (w**2).sum((2, 3)).t()
        demod = torch.rsqrt(sigma + 1e-8).to(conv.dtype)
    xs = x.to(conv.dtype) * s[:, :, None, None].to(conv.dtype)
    w = w.to(conv.dtype)
    if conv.upsample:
        y = conv.blur(F.conv_transpose2d(xs, w.transpose(0, 1), stride=2))
    else:
        y = F.conv2d(xs, w, padding=conv.kernel_size // 2)
    if conv.demodulate:
        y = y * demod[:, :, None, None]
    return y


def parent_styled_conv(layer, x, style, noise=None, generator=None):
    y = parent_modulated_conv(layer.conv, x, style)
    if noise is None:
        n, _, h, w = y.shape
        noise = torch.randn((n, 1, h, w), generator=generator, device=y.device, dtype=y.dtype)
    y = y + layer.noise.weight.to(y.dtype) * noise.to(y.dtype)
    return fused_act.fused_leaky_relu(y, layer.bias.to(y.dtype))


@contextlib.contextmanager
def parent(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(T.ModulatedConv, "forward", parent_modulated_conv)
        m.setattr(T.StyledConv, "forward", parent_styled_conv)
        yield


@pytest.fixture
def epilogues(monkeypatch):
    """The list of the epilogue calls the model makes (their dtypes)."""
    calls = []

    def spy(x, *args, **kw):
        calls.append(x.dtype)
        return fused_act.styled_leaky_relu(x, *args, **kw)

    monkeypatch.setattr(T, "styled_leaky_relu", spy)
    return calls


def randomize(module, seed):
    """Every parameter drawn anew, so the zero-initialised biases and noise
    weights matter (modulation biases around 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            v = torch.randn(p.shape, generator=g, dtype=torch.float32)
            if name.endswith("bias") or name.endswith("noise.weight"):
                v = 0.3 * v + (1.0 if ".modulation." in name else 0.0)
            p.copy_(v)
    return module


def generator_model(dtype=torch.float32, seed=0):
    g = T.StyleGAN2Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, width_scale=WIDTH,
                             dtype=dtype, device="cpu")
    return randomize(g, seed)


def latents(seed, n=BS):
    return torch.randn((n, STYLE_DIM), generator=torch.Generator().manual_seed(seed))


# ----------------------------------------------------------------------
# autograd off: the epilogue


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("upsample", [False, True], ids=["plain", "up"])
@pytest.mark.parametrize("given", [True, False], ids=["noise", "drawn"])
def test_styled_conv_without_autograd_equals_the_composition(monkeypatch, epilogues, dtype,
                                                             upsample, given):
    layer = randomize(T.StyledConv(8, 16, STYLE_DIM, upsample=upsample, dtype=dtype,
                                   device="cpu"), 1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((BS, 8, 8, 8), generator=g)
    style = torch.randn((BS, STYLE_DIM), generator=g)
    side = 16 if upsample else 8
    noise = torch.randn((BS, 1, side, side), generator=g) if given else None
    ga, gb = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    with torch.no_grad():
        got = layer(x, style, noise, ga)
        with parent(monkeypatch):
            want = layer(x, style, noise, gb)
    assert epilogues == [dtype]
    assert got.dtype == want.dtype == dtype and got.shape == (BS, 16, side, side)
    assert torch.equal(got, want)
    assert torch.equal(ga.get_state(), gb.get_state())


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_sample_draws_the_same_noises_and_images(monkeypatch, epilogues, dtype):
    gen = generator_model(dtype)
    z1, z2 = latents(4), latents(5)
    ga, gb = torch.Generator().manual_seed(6), torch.Generator().manual_seed(6)
    with torch.no_grad():
        got = gen.sample([z1, z2], mixing_cutoff=3, generator=ga)
        with parent(monkeypatch):
            want = gen.sample([z1, z2], mixing_cutoff=3, generator=gb)
    assert len(epilogues) == 5  # conv1, then conv_up and conv at 8 and 16 px
    assert got.shape == (BS, SIZE, SIZE, 3)
    assert torch.equal(got, want)
    assert torch.equal(ga.get_state(), gb.get_state())


# ----------------------------------------------------------------------
# autograd on: the composition, as before


def g_step(gen, disc):
    """A G step's loss and images, with noises drawn from a seeded generator."""
    imgs = gen.sample([latents(7), latents(8)], mixing_cutoff=2,
                      generator=torch.Generator().manual_seed(9))
    loss = losses.g_nonsaturating_loss(disc(imgs)[0])
    loss.backward()
    return loss, imgs


def path_step(gen, disc):
    """The path-length step's penalty and images (its double backward)."""
    del disc
    n = BS // 2
    g = torch.Generator().manual_seed(10)
    noises = [torch.randn(s, generator=g) for s in gen.synthesis.noise_shapes(n)]
    w = gen.mapping(latents(11, n))
    styles = w[:, None, :].expand(-1, gen.n_latent, -1)
    imgs = gen.synthesis(styles, noises).permute(0, 2, 3, 1)
    pen, _, _ = losses.path_length_penalty(imgs, styles, torch.randn(imgs.shape, generator=g),
                                           torch.zeros(()))
    (2.0 * pen + 0.0 * imgs[:1].sum()).backward()
    return pen, imgs


@pytest.mark.parametrize("step", [g_step, path_step], ids=["g", "path"])
def test_autograd_keeps_the_parent_formulation(monkeypatch, epilogues, step):
    def run():
        gen = generator_model()
        disc = randomize(T.StyleGAN2Discriminator(size=SIZE, width_scale=WIDTH, device="cpu"), 12)
        disc.requires_grad_(False)
        out = step(gen, disc)
        return out, {k: p.grad for k, p in gen.named_parameters()}

    (got, got_grads) = run()
    with parent(monkeypatch):
        (want, want_grads) = run()
    assert epilogues == []
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got_grads.keys() == want_grads.keys()
    for k in got_grads:
        assert got_grads[k] is not None, k
        assert torch.equal(got_grads[k], want_grads[k]), k


def test_the_epilogue_refuses_a_graph():
    x = torch.randn((2, 4, 3, 3), requires_grad=True)
    d, b = torch.rand((2, 4)), torch.zeros(4)
    n, w = torch.randn((2, 1, 3, 3)), torch.tensor(0.5)
    with pytest.raises(RuntimeError, match="autograd off"):
        fused_act.styled_leaky_relu(x, b, d, n, w)
    with torch.no_grad():
        want = fused_act.fused_leaky_relu_plain(x * d[:, :, None, None] + w * n, b)
        assert torch.equal(fused_act.styled_leaky_relu(x, b, d, n, w), want)


# ----------------------------------------------------------------------
# everything else keeps the plain bias-act


def test_d_mapping_and_sngan_take_no_epilogue(monkeypatch, epilogues):
    plain = []
    real = T.fused_leaky_relu
    monkeypatch.setattr(T, "fused_leaky_relu",
                        lambda x, b, *a: plain.append(x.shape[1:]) or real(x, b, *a))
    disc = T.StyleGAN2Discriminator(size=SIZE, width_scale=WIDTH, device="cpu")
    mapping = T.MappingNetwork(STYLE_DIM, N_MLP, device="cpu")
    sg, sd = sngan.SNGANGenerator32(nz=16, ngf=16, device="cpu"), \
        sngan.SNGANDiscriminator32(ndf=16, device="cpu")
    with torch.no_grad():
        disc(torch.randn((BS, SIZE, SIZE, 3)))
        n_disc = len(plain)
        mapping(latents(13))
        sd(sg(torch.randn((BS, 16))))
    assert epilogues == []
    # D: from_rgb, two convs a block, the final conv, the dense layer
    assert n_disc == 1 + 2 * len(disc.blocks) + 2
    assert len(plain) == n_disc + N_MLP  # the mapping's layers; SNGAN has none


class _Kernel:
    """Stands in for the Triton kernel: records each launch's arguments."""

    def __init__(self):
        self.launches = []

    def __getitem__(self, grid):
        return lambda *args, **kw: self.launches.append((grid, args, kw))


def test_launch_flags(monkeypatch):
    """The plain bias-act launches `flr_fwd` with STYLED off and its default
    build; the epilogue with it on and FMA contraction off, counted apart."""
    kernel = _Kernel()
    monkeypatch.setattr(fused_act, "_kernels", lambda: (kernel, None, None))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    x, b = torch.randn((2, 4, 3, 5)), torch.randn(4)
    d, n, w = torch.rand((2, 4)), torch.randn((2, 1, 3, 5)), torch.tensor(0.5)
    fused_act._launch_forward(x, b, 0.2, math.sqrt(2.0))
    fused_act._launch_forward(x, b, 0.2, math.sqrt(2.0), (d, n, w))
    (grid0, args0, kw0), (grid1, args1, kw1) = kernel.launches
    assert grid0 == grid1 == (1,)
    assert kw0 == {"STYLED": False, "CLAMP": False, "BLOCK": 1024, "num_warps": 4}
    assert kw1 == {"STYLED": True, "CLAMP": False, "BLOCK": 1024, "num_warps": 4,
                   "enable_fp_fusion": False}
    assert args0[6:] == args1[6:] == (x.numel(), 15, 4, 0.2, math.sqrt(2.0), 0.0)
    assert args1[3] is d and args1[4] is n and args1[5] is w
    assert _build.LAUNCHES["fused_leaky_relu"] == 1 == _build.LAUNCHES["styled_leaky_relu"]
    with pytest.raises(ValueError, match="demod"):
        fused_act._launch_forward(x, b, 0.2, 1.0, (d.t().contiguous(), n, w))
    with pytest.raises(ValueError, match="noise "):
        fused_act._launch_forward(x, b, 0.2, 1.0, (d, n[:, :, :2].contiguous(), w))
    with pytest.raises(ValueError, match="noise_weight"):
        fused_act._launch_forward(x, b, 0.2, 1.0, (d, n, w.double()))
    with pytest.raises(ValueError, match="map"):
        fused_act._launch_forward(x[:, :, 0, 0].contiguous(), b, 0.2, 1.0, (d, n, w))
