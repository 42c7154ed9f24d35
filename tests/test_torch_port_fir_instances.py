"""Which instance of the upfirdn2d kernel each call takes.

The CUDA kernel (diagan_tpu_torch/csrc/upfirdn2d.cu) has one instance per
shape family of the main paths and a generic one for anything else; the
wrapper chooses it with `fir_instance`, from the arguments alone. Here, on the
CPU, a spy on the autograd Function records every upfirdn2d call that a
training step makes (D and G with ADA, R1 and path regularisation, so
forward, backward and double backward) and that ADA's resample makes in
both forms, and each must map to a family's own instance. The odd
configurations of test_torch_port_ops.py (other tap sizes, up = 3) map to
the generic one, and the codes agree with the CUDA source's table. A
StyleGAN3-T G forward with autograd off takes family instances alone: its
24-tap up-4 passes the float32 pair fir24x_up4 / fir24y_up4, whose bfloat16
and channels-last forms, and whose down-4 backward, stay generic.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_ops import CONFIGS, FAMILY_CONFIGS, _taps  # noqa: E402

from diagan_tpu_torch.models import ada, stylegan3  # noqa: E402
from diagan_tpu_torch.models.stylegan2 import (  # noqa: E402
    StyleGAN2Discriminator,
    StyleGAN2Generator,
)
from diagan_tpu_torch.ops import _build  # noqa: E402
from diagan_tpu_torch.ops.upfirdn2d import (  # noqa: E402
    _FAMILIES,
    _UP4,
    FIR_INSTANCES,
    _backward_args,
    _Upfirdn2d,
    fir_instance,
    layout,
)
from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "diagan_tpu_torch" / "csrc" / "upfirdn2d.cu"


@pytest.fixture
def fir_calls(monkeypatch):
    """Every _Upfirdn2d.forward call as (input shape, taps shape, up, down,
    pad, counter, instance)."""
    calls = []
    forward = _Upfirdn2d.forward

    def spy(ctx, x, taps, up, down, pad, counter):
        instance = fir_instance(*taps.shape, up, down, x.dtype, layout(x))
        calls.append((tuple(x.shape), tuple(taps.shape), up, down, pad, counter, instance))
        return forward(ctx, x, taps, up, down, pad, counter)

    monkeypatch.setattr(_Upfirdn2d, "forward", staticmethod(spy))
    return calls


def _generic(calls):
    return [c for c in calls if c[-1] == "generic"]


def test_training_step_takes_the_family_instances(fir_calls, tmp_path):
    """One full step at step 0 (D loss, R1, G loss, path length) with ADA on
    every call, on narrow models at 32 px."""
    torch.manual_seed(0)
    g = StyleGAN2Generator(32, 32, 2, 2, width_scale=1 / 16, device="cpu")
    d = StyleGAN2Discriminator(32, 2, width_scale=1 / 16, device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    tr = StyleGAN2Trainer(tmp_path, g, d, images, num_steps=1, batch_size=4, augment_p=1.0,
                          device="cpu")
    m = tr.train_step(0)
    assert {"r1", "path"} <= set(m)
    assert not _generic(fir_calls), _generic(fir_calls)
    taken = {c[-1] for c in fir_calls}
    assert {"fir4x4", "fir4x4_up2", "fir4x4_down2", "fir12y_up2", "fir12y_down2",
            "fir12x_up2", "fir12x_down2"} <= taken, taken
    # backward and double backward ran too (R1 and path length)
    assert {c[5] for c in fir_calls} == {"upfirdn2d", "upfirdn2d_backward"}


@pytest.mark.parametrize("polyphase", [True, False])
def test_ada_resample_takes_the_family_instances(fir_calls, polyphase):
    """apply_affine forward and backward in both forms, on NHWC input (a
    channels-last view once permuted to NCHW)."""
    G = ada.sample_affine_matrices(2, 1.0, 16, 16, torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 16, 3, requires_grad=True)
    out = ada.apply_affine(x, G, polyphase=polyphase)
    out.sum().backward()
    assert x.grad.shape == x.shape
    assert not _generic(fir_calls), _generic(fir_calls)
    taken = {c[-1] for c in fir_calls}
    want = ({"fir12x_up2", "fir6y", "fir6x6", "fir12x_down2"} if polyphase else
            {"fir12y_up2", "fir12x_up2", "fir12y_down2", "fir12x_down2"})
    assert want <= taken, taken


def test_stylegan3_forward_takes_the_family_instances(fir_calls):
    """A StyleGAN3-T G forward with autograd off, as DRS runs it, at 32 px
    (one up-4 layer, L5): every pass on a family's own instance, its x and y
    up-4 passes on the up-4 pair."""
    torch.manual_seed(0)
    g = stylegan3.StyleGAN3Generator(img_resolution=32, channel_base=256, channel_max=8,
                                     device="cpu")
    with torch.no_grad():
        img = g(torch.randn(2, 512))
    assert img.shape == (2, 32, 32, 3) and torch.isfinite(img).all()  # NHWC
    assert fir_calls and not _generic(fir_calls), _generic(fir_calls)
    up4 = [c for c in fir_calls if c[-1] in _UP4]
    assert [c[-1] for c in up4] == ["fir24x_up4", "fir24y_up4"], up4
    assert [c[4] for c in up4] == [(-6, -9, 0, 0), (0, 0, -6, -9)]  # L5's crops
    assert {c[-1] for c in fir_calls} == {"fir24x_up4", "fir24y_up4", "fir12x_up2",
                                          "fir12y_up2", "fir12x_down2", "fir12y_down2"}


@pytest.mark.parametrize("kh,kw,up,want", [(1, 24, (4, 1), "fir24x_up4"),
                                            (24, 1, (1, 4), "fir24y_up4")])
def test_up4_instances_take_float32_nchw_alone(kh, kw, up, want):
    assert fir_instance(kh, kw, up, (1, 1), torch.float32, torch.contiguous_format) == want
    assert fir_instance(kh, kw, up, 1, torch.float32, torch.contiguous_format) == want
    for dtype, fmt in [(torch.bfloat16, torch.contiguous_format),
                       (torch.float32, torch.channels_last), (torch.float16,
                                                              torch.contiguous_format)]:
        assert fir_instance(kh, kw, up, (1, 1), dtype, fmt) == "generic"
    # the other axis, another factor, other taps, a down factor: no family
    assert fir_instance(kw, kh, up, (1, 1), torch.float32, torch.contiguous_format) == "generic"
    assert fir_instance(kh, kw, up[::-1], (1, 1), torch.float32,
                        torch.contiguous_format) == "generic"
    assert fir_instance(kh, kw, tuple(min(u, 2) for u in up), (1, 1), torch.float32,
                        torch.contiguous_format) == "generic"
    assert fir_instance(kh // 2 or 1, kw // 2 or 1, up, (1, 1), torch.float32,
                        torch.contiguous_format) == "generic"  # 12 taps at up 4
    assert fir_instance(kh, kw, up, up, torch.float32, torch.contiguous_format) == "generic"


# the instance each configuration of test_torch_port_ops.py takes
_CONFIG_INSTANCES = ["fir4x4", "generic", "fir4x4", "fir4x4_up2", "fir4x4_down2", "generic",
                     "generic", "fir4x4", "generic", "generic", "generic", "generic", "generic"]
_FAMILY_INSTANCES = ["fir12y_up2", "fir12y_down2", "fir12x_up2", "fir12x_down2", "fir6y",
                     "fir6x6", "fir4x4_up2", "fir4x4_down2", "fir24x_up4", "fir24y_up4"]


@pytest.mark.parametrize("config,want", list(zip(CONFIGS + FAMILY_CONFIGS,
                                                 _CONFIG_INSTANCES + _FAMILY_INSTANCES)))
def test_config_instances(config, want):
    up, down, _, k = config
    kh, kw = _taps(k).shape
    assert len(_CONFIG_INSTANCES) == len(CONFIGS)
    assert len(_FAMILY_INSTANCES) == len(FAMILY_CONFIGS)
    for dtype in (torch.float32, torch.bfloat16):
        # the up-4 pair is float32's alone
        want_dt = "generic" if want in _UP4 and dtype != torch.float32 else want
        assert fir_instance(kh, kw, up, down, dtype, torch.contiguous_format) == want_dt
    # channels-last input and other dtypes take the generic instance
    assert fir_instance(kh, kw, up, down, torch.float32, torch.channels_last) == "generic"
    assert fir_instance(kh, kw, up, down, torch.float16, torch.contiguous_format) == "generic"


@pytest.mark.parametrize("family", sorted(_FAMILIES, key=str))
def test_backward_of_a_family_is_a_family(family):
    """The backward is the op with flipped taps and up and down swapped, so
    the backward and double backward of every family run a family too, but
    for the up-4 pair's: down 4, which no path runs, on the generic
    instance."""
    kh, kw, up, down = family
    bwd_up, bwd_down, _ = _backward_args((40, 40), (40, 40), kh, kw, up, down, (2, 1))
    assert (bwd_up, bwd_down) == (down, up)
    bwd = fir_instance(kh, kw, bwd_up, bwd_down, torch.float32, torch.contiguous_format)
    assert (bwd == "generic") == (_FAMILIES[family] in _UP4), bwd


def test_codes_and_families_match_the_cuda_source():
    src = CSRC.read_text()
    enum = re.search(r"enum Instance \{(.*?)\};", src, re.S).group(1)
    names = [n.split("=")[0].strip().lower() for n in enum.split(",")]
    assert names[:-1] == list(FIR_INSTANCES) and names[-1] == "n_instances"
    table = re.search(r"FAMILIES\[N_INSTANCES\] = \{(.*?)\};", src, re.S).group(1)
    rows = [tuple(int(v) for v in r.split(",")) for r in re.findall(r"\{([^{}]*)\}", table)]
    assert len(rows) == len(FIR_INSTANCES)
    for (kh, kw, up, down), name in _FAMILIES.items():
        assert rows[FIR_INSTANCES.index(name)] == (kh, kw, *up, *down), name
    assert set(_FAMILIES.values()) == set(FIR_INSTANCES) - {"generic"}
    # the up-4 pair: codes 10 and 11, float32 alone on the C side too
    assert [FIR_INSTANCES.index(n) for n in _UP4] == [10, 11]
    assert rows[10] == (1, 24, 4, 1, 1, 1) and rows[11] == (24, 1, 1, 4, 1, 1)
    assert re.search(r"\(instance == FIR24X_UP4 \|\| instance == FIR24Y_UP4\) && dtype != 0",
                     src)


def test_instance_counts_reset_and_stay_zero_on_the_cpu():
    _build.reset_launches()
    assert set(_build.FIR_INSTANCES) == set(FIR_INSTANCES)
    x = torch.randn(1, 2, 9, 9, requires_grad=True)
    ada_taps = ada._sym6_taps(torch.device("cpu"))[1]
    from diagan_tpu_torch.ops import upfirdn2d

    upfirdn2d(x, ada_taps, up=(2, 1), pad=(6, 5, 0, 0)).sum().backward()
    assert all(v == 0 for v in _build.FIR_INSTANCES.values()), _build.FIR_INSTANCES
