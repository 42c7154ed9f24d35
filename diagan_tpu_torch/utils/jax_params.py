"""Weight bridge: the JAX package's Flax StyleGAN2, SNGAN / SSGAN / InfoMax,
MNIST DCGAN, toy, CAE, InceptionV3, LPIPS and small-classifier
(models/convnets.py) variables -> the port's state_dicts; the optax Adam
state of the JAX trainers -> torch Adam moments; and the reference's
(rosinality's) StyleGAN2 state_dicts -> the port's.

Input is a Flax variable tree as nested dicts of numpy arrays (what
`jax.device_get(variables["params"])` gives); this module never imports jax.
Every leaf goes through exactly one rule; a leaf no rule knows raises, and
`load_state_dict` (strict) then checks that no port parameter was missed.

Layout conversions:
  - conv kernel (kh, kw, I, O)  -> weight (O, I, kh, kw);
  - the upsampling ModulatedConv kernel is also flipped in both spatial axes:
    lax.conv_transpose correlates with the kernel as given, while
    F.conv_transpose2d convolves with it;
  - dense kernel (I, O) -> weight (O, I); the discriminator's first dense
    layer reads a flatten, whose rows go from the JAX (H, W, C) order to the
    port's (C, H, W) order;
  - synthesis input (1, 4, 4, C) -> (1, C, 4, 4);
  - SNGAN (torch-mimicry's key layout, models/sngan.py): the generator's l1
    output rows go from the Flax (y, x, c) reshape to torch-mimicry's (c, y,
    x) one (the inverse of diagan_tpu/utils/mimicry_import.py:_bottom_dense);
    BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
    (num_batches_tracked 0); a spectral layer's `u` (1, out) -> `weight_u`
    (out,), and its stored sigma is dropped: every forward recomputes it from
    (W, u) (models/layers.py); SSGAN's and InfoMax's discriminators nest
    the SNGAN backbone under SNGANDiscriminator{32,64}_0 and their heads
    under _SSHead_0 (-> l_y) and _InfoMaxHeads_0 (-> local_nn, global_nn.0,
    global_nn.2), as diagan_tpu/utils/mimicry_import.py maps them;
  - InceptionV3 (eval/inception.py): the Flax auto-named ConvBN_k modules,
    sorted naturally (ConvBN_10 after ConvBN_2, as the JAX loader sorts
    them), go in order to the port's ConvBN modules, which carry
    torchvision's names in torchvision's order;
  - the convnets: Conv_i / BatchNorm_i -> conv{i} / bn{i}, the Dense layers
    in order to the port's fc names (Simple3DNet's tree sits under
    SimpleConvNet_0);
  - the MNIST DCGAN (the reference's torch layout, models/mnist_dcgan.py;
    the inverse of diagan_tpu/utils/torch_import.py:import_mnist_dcgan_*):
    Dense_0 -> fc, ConvTranspose_i -> tconv.{0,3,6,9} with the kernel
    flipped in both spatial axes (torch's transposed conv convolves,
    lax.conv_transpose correlates), Conv_i / SNConv_i -> conv.{0,3,7,11,15,19},
    BatchNorm_i -> tconv.{1,4,7} / conv.{4,8,12,16,20}, and D's head Dense_0
    -> out_d with its rows from the (H, W, C) flatten to the (C, H, W) one;
  - the toy MLPs: the Dense (or SNDense) layers in order -> fc0..fc3;
  - the CAE (models/cae.py): encode/Conv_i, BatchNorm_i -> convs.i, bns.i;
    encode/Dense_0 -> fc_enc with its columns from the (H, W, C) flatten to
    the (C, H, W) one; decode/Dense_0 -> fc_dec and decode/BatchNorm_0 ->
    bn_dec, their rows (and the per-feature BatchNorm's parameters and
    statistics) from the (H, W, C) reshape to the (C, H, W) one;
    decode/ConvTranspose_j -> tconvs.j, the last one tconv_out, each kernel
    flipped in both spatial axes; decode/BatchNorm_j (j >= 1) -> tbns.{j-1};
  - LPIPS's VGG16 stack (eval/lpips.py): Conv_i -> convs.i;
  - the mimicry bridges take {"params"} alone too (optax's mu and nu, whose
    trees are the params'); the collections they find beside it
    (batch_stats, spectral) are mapped as well;
  - optax.adam's state {"0": {"count", "mu", "nu"}, "1": {}} (the
    regularisation-ratio Adam of diagan_tpu/train/stylegan2_trainer.py; with
    the mimicry trainer's linear decay "1" holds the schedule's count):
    mu and nu are trees of the params' shape and go through the params' own
    rule (every rule is a permutation, so the moments map leaf for leaf);
    count becomes each parameter's Adam step;
  - the reference's StyleGAN2 (stylegan2/model.py of rosinality's port, its
    `{iter:06d}.pt` files): its flat keys map to the port's names (style.i
    -> mapping.layers.{i-1}; convs.{2j} / convs.{2j+1} / to_rgbs.j ->
    conv_up_{r} / conv_{r} / to_rgb_{r}, r = 2**(j+3); D's convs.0 ->
    from_rgb, convs.{b} -> blocks.{b-1}, final_linear.0 / .1 ->
    final_linear / out_linear). The port keeps the reference's conv layouts,
    the upsampling convs' kernels (which the JAX import flips) and D's (C,
    H, W) flatten, so no array is permuted: modulated weights drop their
    leading 1, noise weights and ToRGB biases are reshaped. The fixed blur
    kernels and the noises.noise_i buffers are consumed with no
    counterpart (the port recomputes the blurs and draws its noise); the
    reference's bias-free ResBlock skip conv gets the zero bias the port's
    layer carries. A key no rule knows raises.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from diagan_tpu_torch.eval.inception import InceptionV3, conv_bn_names


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value, dtype=np.float32)


def _conv(k):
    return k.transpose(3, 2, 0, 1)


def _modulated_conv_leaf(rest, arr, upsample):
    """(suffix, array) for a leaf inside a ModulatedConv, or None."""
    if rest == ("kernel",):
        k = _conv(arr)
        return "weight", k[:, :, ::-1, ::-1] if upsample else k
    if rest == ("modulation", "kernel"):
        return "modulation.weight", arr.T
    if rest == ("modulation", "bias"):
        return "modulation.bias", arr
    return None


def _convert(params, rule, what):
    sd = {}
    for path, arr in _flatten(params):
        hit = rule(path, arr)
        if hit is None:
            raise ValueError(f"{what} bridge: no rule for Flax leaf {'/'.join(path)} "
                             f"with shape {arr.shape}")
        key, value = hit
        if key is None:  # consumed, with no counterpart in the port
            continue
        if key in sd:
            raise ValueError(f"{what} bridge: two leaves map to {key}")
        # ascontiguousarray (flipped kernels) would make a 0-d leaf 1-d
        sd[key] = torch.tensor(np.ascontiguousarray(value).reshape(np.shape(value)))
    return sd


def modulated_conv_state_dict(params, upsample=False):
    """Flax ModulatedConv params -> the port ModulatedConv's state_dict."""
    return _convert(params, lambda path, arr: _modulated_conv_leaf(path, arr, upsample),
                    "ModulatedConv")


def _generator_rule(path, arr):
    if path[0] == "mapping" and len(path) == 3:
        m = re.fullmatch(r"EqualDense_(\d+)", path[1])
        if m and path[2] in ("kernel", "bias"):
            name = "weight" if path[2] == "kernel" else "bias"
            return f"mapping.layers.{m.group(1)}.{name}", arr.T if name == "weight" else arr
        return None
    if path[0] != "synthesis":
        return None
    if path[1:] == ("input",):
        return "synthesis.input", arr.transpose(0, 3, 1, 2)
    layer, rest = path[1], path[2:]
    prefix = f"synthesis.layers.{layer}"
    if not re.fullmatch(r"conv1|to_rgb1|conv_up_\d+|conv_\d+|to_rgb_\d+", layer):
        return None
    if rest and rest[0] == "conv":
        hit = _modulated_conv_leaf(rest[1:], arr, layer.startswith("conv_up_"))
        return None if hit is None else (f"{prefix}.conv.{hit[0]}", hit[1])
    if rest == ("noise", "weight") and not layer.startswith("to_rgb"):
        return f"{prefix}.noise.weight", arr
    if rest == ("bias",):
        return f"{prefix}.bias", arr
    return None


def generator_state_dict(params):
    """Flax StyleGAN2Generator params -> the port generator's state_dict."""
    return _convert(params, _generator_rule, "generator")


def _conv_layer_leaf(rest, arr):
    if rest == ("EqualConv_0", "kernel"):
        return "conv.weight", _conv(arr)
    if rest == ("EqualConv_0", "bias"):
        return "conv.bias", arr
    if rest == ("bias",):
        return "bias", arr
    return None


_D_CONV_LAYERS = {"ConvLayer_0": "from_rgb", "ConvLayer_1": "final_conv"}
_D_BLOCK_LAYERS = {"ConvLayer_0": "conv1", "ConvLayer_1": "conv2", "ConvLayer_2": "skip"}


def _discriminator_rule(path, arr):
    head, rest = path[0], path[1:]
    if head in _D_CONV_LAYERS:
        hit = _conv_layer_leaf(rest, arr)
        return None if hit is None else (f"{_D_CONV_LAYERS[head]}.{hit[0]}", hit[1])
    m = re.fullmatch(r"DResBlock_(\d+)", head)
    if m and rest and rest[0] in _D_BLOCK_LAYERS:
        hit = _conv_layer_leaf(rest[1:], arr)
        if hit is None:
            return None
        return f"blocks.{m.group(1)}.{_D_BLOCK_LAYERS[rest[0]]}.{hit[0]}", hit[1]
    if head == "EqualDense_0" and rest == ("kernel",):
        # rows of the (4, 4, C) NHWC flatten -> the port's (C, 4, 4) flatten
        c = arr.shape[0] // 16
        w = arr.reshape(4, 4, c, -1).transpose(3, 2, 0, 1).reshape(-1, c * 16)
        return "final_linear.weight", w
    if head == "EqualDense_0" and rest == ("bias",):
        return "final_linear.bias", arr
    if head == "EqualDense_1" and rest in (("kernel",), ("bias",)):
        return ("out_linear.weight", arr.T) if rest == ("kernel",) else ("out_linear.bias", arr)
    return None


def discriminator_state_dict(params):
    """Flax StyleGAN2Discriminator params -> the port discriminator's state_dict."""
    return _convert(params, _discriminator_rule, "discriminator")


def _bn_leaf(prefix, leaf, arr):
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    return (f"{prefix}.{names[leaf]}", arr) if leaf in names else None


def _indexed(name, stem):
    """i for a Flax auto-name f"{stem}_{i}", else None."""
    m = re.fullmatch(rf"{stem}_(\d+)", name)
    return int(m.group(1)) if m else None


def _spectral_leaf(coll, inner, layer, prefix, arr):
    """The weight / bias / u of a Flax SN layer (its sigma is dropped: every
    forward recomputes it), or None."""
    if coll == "params" and inner == (layer, "kernel"):
        return f"{prefix}.weight", arr.T if layer == "Dense_0" else _conv(arr)
    if coll == "params" and inner == (layer, "bias"):
        return f"{prefix}.bias", arr
    if coll == "spectral" and inner == ("SpectralNorm_0", f"{layer}/kernel/u"):
        return f"{prefix}.weight_u", arr.reshape(-1)
    if coll == "spectral" and inner == ("SpectralNorm_0", f"{layer}/kernel/sigma"):
        return None, None
    return None


def _collections(variables, *names):
    """{"params", and whichever of the collections `names` `variables` holds}:
    a bridge then also maps a params-only tree, as optax's mu and nu are."""
    return {"params": variables["params"], **{k: variables[k] for k in names if k in variables}}


def _with_batches_tracked(sd):
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return sd


_G_BLOCK = {"BatchNorm_0": "b1", "BatchNorm_1": "b2", "Conv_0": "c1", "Conv_1": "c2",
            "Conv_2": "c_sc"}


def _sngan_generator_rule(ngf, top):
    def rule(path, arr):
        coll, head, rest = path[0], path[1], path[2:]
        if coll == "params" and head == "Dense_0" and rest == ("kernel",):
            nz, b = arr.shape[0], int(round((arr.shape[1] // ngf) ** 0.5))
            return "l1.weight", arr.T.reshape(b, b, ngf, nz).transpose(2, 0, 1, 3).reshape(-1, nz)
        if coll == "params" and head == "Dense_0" and rest == ("bias",):
            b = int(round((arr.shape[0] // ngf) ** 0.5))
            return "l1.bias", arr.reshape(b, b, ngf).transpose(2, 0, 1).reshape(-1)
        m = re.fullmatch(r"GBlock_(\d+)", head)
        if m and len(rest) == 2 and rest[0] in _G_BLOCK:
            prefix = f"block{int(m.group(1)) + 2}.{_G_BLOCK[rest[0]]}"
        elif head in ("BatchNorm_0", "Conv_0") and len(rest) == 1:
            prefix = f"b{top}" if head == "BatchNorm_0" else f"c{top}"
            rest = (head, *rest)
        else:
            return None
        layer, leaf = rest
        if layer.startswith("BatchNorm"):
            if (coll == "params") != (leaf in ("scale", "bias")):
                return None
            return _bn_leaf(prefix, leaf, arr)
        if coll == "params" and leaf == "kernel":
            return f"{prefix}.weight", _conv(arr)
        if coll == "params" and leaf == "bias":
            return f"{prefix}.bias", arr
        return None
    return rule


def sngan_generator_state_dict(variables):
    """Flax SNGANGenerator{32,64} variables {"params", "batch_stats"} -> the
    port generator's state_dict (torch-mimicry's layout)."""
    params = variables["params"]
    n_blocks = sum(1 for k in params if k.startswith("GBlock_"))
    ngf = params["GBlock_0"]["Conv_0"]["kernel"].shape[2]
    return _with_batches_tracked(_convert(_collections(variables, "batch_stats"),
                                          _sngan_generator_rule(ngf, n_blocks + 2),
                                          "SNGAN generator"))


def _sngan_discriminator_rule(head_name):
    def rule(path, arr):
        coll, head, rest = path[0], path[1], path[2:]
        if head == "SNDense_0":
            prefix, inner = head_name, rest
        else:
            m = re.fullmatch(r"DBlock_(\d+)", head)
            if head == "DBlockOptimized_0":
                block = "block1"
            elif m:
                block = f"block{int(m.group(1)) + 2}"
            else:
                return None
            c = re.fullmatch(r"SNConv_([012])", rest[0]) if rest else None
            if c is None:
                return None
            prefix, inner = f"{block}.{('c1', 'c2', 'c_sc')[int(c.group(1))]}", rest[1:]
        layer = "Dense_0" if head == "SNDense_0" else "Conv_0"
        return _spectral_leaf(coll, inner, layer, prefix, arr)
    return rule


def _sngan_head_name(backbone_params):
    return f"l{2 + sum(1 for k in backbone_params if k.startswith('DBlock_'))}"


def sngan_discriminator_state_dict(variables):
    """Flax SNGANDiscriminator{32,64} variables {"params", "spectral"} -> the
    port discriminator's state_dict (torch-mimicry's layout)."""
    return _convert(_collections(variables, "spectral"),
                    _sngan_discriminator_rule(_sngan_head_name(variables["params"])),
                    "SNGAN discriminator")


def _headed_discriminator_state_dict(variables, heads, what):
    """A Flax discriminator that wraps SNGANDiscriminator{32,64}_0 and adds
    head modules -> the port's state_dict: the backbone's leaves by the SNGAN
    rule, each head layer's by `heads` {(Flax head module, its SN layer): port
    prefix}."""
    params = variables["params"]
    (backbone,) = [k for k in params if re.fullmatch(r"SNGANDiscriminator(32|64)_0", k)]
    base = _sngan_discriminator_rule(_sngan_head_name(params[backbone]))

    def rule(path, arr):
        coll, head, rest = path[0], path[1], path[2:]
        if head == backbone:
            return base((coll, *rest), arr)
        prefix = heads.get((head, rest[0])) if rest else None
        if prefix is None:
            return None
        layer = "Conv_0" if rest[0].startswith("SNConv") else "Dense_0"
        return _spectral_leaf(coll, rest[1:], layer, prefix, arr)

    return _convert(_collections(variables, "spectral"), rule, what)


def ssgan_discriminator_state_dict(variables):
    """Flax SSGANDiscriminator{32,64} variables {"params", "spectral"} -> the
    port's state_dict: the backbone (SNGANDiscriminator{32,64}_0) as SNGAN's,
    _SSHead_0/SNDense_0 -> l_y."""
    return _headed_discriminator_state_dict(
        variables, {("_SSHead_0", "SNDense_0"): "l_y"}, "SSGAN discriminator")


def infomax_discriminator_state_dict(variables):
    """Flax InfoMaxGANDiscriminator{32,64} variables {"params", "spectral"} ->
    the port's state_dict: the backbone as SNGAN's, _InfoMaxHeads_0's
    SNConv_0 / SNDense_0 / SNDense_1 -> local_nn / global_nn.0 / global_nn.2."""
    return _headed_discriminator_state_dict(
        variables, {("_InfoMaxHeads_0", "SNConv_0"): "local_nn",
                    ("_InfoMaxHeads_0", "SNDense_0"): "global_nn.0",
                    ("_InfoMaxHeads_0", "SNDense_1"): "global_nn.2"}, "InfoMax discriminator")


def _natural_key(path):
    """Sort key where 'ConvBN_10' sorts after 'ConvBN_2' (the JAX package's
    inception.py:_natural_key)."""
    key = []
    for comp in path:
        stem, _, num = comp.rpartition("_")
        key.append((stem, int(num)) if stem and num.isdigit() else (comp, -1))
    return key


def inception_state_dict(variables, module=None):
    """Flax InceptionV3 variables {"params", "batch_stats"} -> the port
    InceptionV3's state_dict: conv HWIO -> OIHW, BatchNorm scale / bias /
    mean / var -> weight / bias / running_mean / running_var
    (num_batches_tracked 0), Dense kernel transposed into fc. `module` is the
    port module the tree belongs to (default the whole InceptionV3; one
    Inception block takes its block's variables)."""
    names = conv_bn_names(module if module is not None else InceptionV3(device="meta"))
    tree = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    leaves = dict(_flatten(tree))
    # a ConvBN is a Flax module holding Conv_0 and BatchNorm_0: its path
    # below the collection, in natural order
    convbns = sorted({path[1:-2] for path in leaves
                      if path[0] == "params" and path[-2:-1] == ("Conv_0",)},
                     key=_natural_key)
    if len(convbns) != len(names):
        raise ValueError(f"Inception bridge: {len(convbns)} Flax ConvBN modules for "
                         f"{len(names)} port ones")
    rules = {}
    for name, mod in zip(names, convbns):
        rules[("params", *mod, "Conv_0", "kernel")] = (f"{name}.conv.weight", _conv)
        for coll, leaf, part in (("params", "scale", "weight"), ("params", "bias", "bias"),
                                 ("batch_stats", "mean", "running_mean"),
                                 ("batch_stats", "var", "running_var")):
            rules[(coll, *mod, "BatchNorm_0", leaf)] = (f"{name}.bn.{part}", None)
    rules[("params", "Dense_0", "kernel")] = ("fc.weight", np.transpose)
    rules[("params", "Dense_0", "bias")] = ("fc.bias", None)

    def rule(path, arr):
        hit = rules.get(path)
        if hit is None:
            return None
        key, fn = hit
        return key, arr if fn is None else fn(arr)

    sd = _convert(tree, rule, "Inception")
    for name in names:
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def _convnet_rule(dense_names, prefix=()):
    """Rule for the convnets (models/convnets.py): Conv_i -> conv{i}, BatchNorm_i
    -> bn{i}, Dense_i -> dense_names[i], under the module path `prefix`."""
    def rule(path, arr):
        coll, rest = path[0], path[1:]
        if rest[:len(prefix)] != prefix or len(rest) != len(prefix) + 2:
            return None
        (layer, leaf) = rest[len(prefix):]
        kind, _, i = layer.rpartition("_")
        if not i.isdigit():
            return None
        i = int(i)
        if kind == "BatchNorm" and (coll == "params") == (leaf in ("scale", "bias")):
            return _bn_leaf(f"bn{i}", leaf, arr)
        if coll != "params" or leaf not in ("kernel", "bias"):
            return None
        if kind == "Conv":
            return f"conv{i}.{'weight' if leaf == 'kernel' else 'bias'}", (
                _conv(arr) if leaf == "kernel" else arr)
        if kind == "Dense" and i < len(dense_names):
            return f"{dense_names[i]}.{'weight' if leaf == 'kernel' else 'bias'}", (
                arr.T if leaf == "kernel" else arr)
        return None
    return rule


def _convnet_state_dict(variables, dense_names, what, prefix=()):
    tree = _collections(variables, "batch_stats")
    return _with_batches_tracked(_convert(tree, _convnet_rule(dense_names, prefix), what))


def simple_convnet_state_dict(variables):
    """Flax SimpleConvNet variables {"params", "batch_stats"} -> the port's."""
    return _convnet_state_dict(variables, ("fc",), "SimpleConvNet")


def simple3dnet_state_dict(variables):
    """Flax Simple3DNet variables (a SimpleConvNet_0 inside) -> the port's."""
    return _convnet_state_dict(variables, ("fc",), "Simple3DNet", prefix=("SimpleConvNet_0",))


def simple_net_state_dict(variables):
    """Flax SimpleNet variables {"params"} -> the port's (its first Dense reads
    the NHWC flatten, as the port's fc0 does: no permutation)."""
    return _convnet_state_dict(variables, ("fc0", "fc1", "fc2", "fc3"), "SimpleNet")


def attr_classifier_state_dict(variables):
    """Flax AttrClassifier variables {"params", "batch_stats"} -> the port's."""
    return _convnet_state_dict(variables, ("fc1", "fc2"), "AttrClassifier")


_DCGAN_G_TCONV = (0, 3, 6, 9)
_DCGAN_G_BN = (1, 4, 7)
_DCGAN_D_CONV = (0, 3, 7, 11, 15, 19)
_DCGAN_D_BN = (4, 8, 12, 16, 20)


def mnist_dcgan_generator_state_dict(variables):
    """Flax MNISTDCGANGenerator variables {"params", "batch_stats"} -> the
    port generator's state_dict."""
    def rule(path, arr):
        coll, head, rest = path[0], path[1], path[2:]
        if coll == "params" and head == "Dense_0" and rest == ("kernel",):
            return "fc.weight", arr.T
        if coll == "params" and head == "Dense_0" and rest == ("bias",):
            return "fc.bias", arr
        i = _indexed(head, "ConvTranspose")
        if coll == "params" and i is not None and i < 4 and rest == ("kernel",):
            return f"tconv.{_DCGAN_G_TCONV[i]}.weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        i = _indexed(head, "BatchNorm")
        if (i is not None and i < 3 and len(rest) == 1
                and (coll == "params") == (rest[0] in ("scale", "bias"))):
            return _bn_leaf(f"tconv.{_DCGAN_G_BN[i]}", rest[0], arr)
        return None

    return _with_batches_tracked(_convert(_collections(variables, "batch_stats"), rule,
                                          "MNIST DCGAN generator"))


def mnist_dcgan_discriminator_state_dict(variables):
    """Flax MNISTDCGANDiscriminator variables {"params", "batch_stats"[,
    "spectral"]} -> the port discriminator's state_dict."""
    def rule(path, arr):
        coll, head, rest = path[0], path[1], path[2:]
        if coll == "params" and head == "Dense_0" and rest == ("kernel",):
            return "out_d.weight", arr.reshape(4, 4, 512, 1).transpose(3, 2, 0, 1).reshape(1, -1)
        if coll == "params" and head == "Dense_0" and rest == ("bias",):
            return "out_d.bias", arr
        i = _indexed(head, "Conv")
        if coll == "params" and i is not None and i < 6 and rest == ("kernel",):
            return f"conv.{_DCGAN_D_CONV[i]}.weight", _conv(arr)
        i = _indexed(head, "SNConv")
        if i is not None and i < 6:
            return _spectral_leaf(coll, rest, "Conv_0", f"conv.{_DCGAN_D_CONV[i]}", arr)
        i = _indexed(head, "BatchNorm")
        if (i is not None and i < 5 and len(rest) == 1
                and (coll == "params") == (rest[0] in ("scale", "bias"))):
            return _bn_leaf(f"conv.{_DCGAN_D_BN[i]}", rest[0], arr)
        return None

    return _with_batches_tracked(_convert(_collections(variables, "batch_stats", "spectral"),
                                          rule, "MNIST DCGAN discriminator"))


def _toy_rule(n_dense):
    """Dense_i (or SNDense_i, then the head Dense_0) in order -> fc{i}."""
    def rule(path, arr):
        coll, head, rest = path[0], path[1], path[2:]
        i = _indexed(head, "SNDense")
        if i is not None and i < 3:
            return _spectral_leaf(coll, rest, "Dense_0", f"fc{i}", arr)
        i = _indexed(head, "Dense")
        if coll == "params" and i is not None and i < n_dense and len(rest) == 1:
            name = f"fc{i + 4 - n_dense}"
            if rest == ("kernel",):
                return f"{name}.weight", arr.T
            if rest == ("bias",):
                return f"{name}.bias", arr
        return None
    return rule


def _toy_state_dict(variables, what):
    tree = _collections(variables, "spectral")
    n_dense = sum(1 for k in variables["params"] if _indexed(k, "Dense") is not None)
    return _convert(tree, _toy_rule(n_dense), what)


def toy_generator_state_dict(variables):
    """Flax ToyGenerator variables {"params"} -> the port's."""
    return _toy_state_dict(variables, "toy generator")


def toy_discriminator_state_dict(variables):
    """Flax ToyDiscriminator variables {"params"[, "spectral"]} -> the port's."""
    return _toy_state_dict(variables, "toy discriminator")


def cae_state_dict(variables):
    """Flax CAE variables {"params", "batch_stats"} (diagan_tpu/models/cae.py)
    -> the port CAE's state_dict (see the module docstring)."""
    enc = variables["params"]["encode"]
    n = sum(1 for k in enc if _indexed(k, "Conv") is not None)
    top = enc[f"Conv_{n - 1}"]["kernel"].shape[-1]

    def chw(a):  # a (4 * 4 * top, ...) array's leading axis from (H, W, C) to (C, H, W)
        return a.reshape((4, 4, top) + a.shape[1:]).transpose(
            (2, 0, 1) + tuple(range(3, a.ndim + 2))).reshape(a.shape)

    def rule(path, arr):
        coll, part, head, rest = path[0], path[1], path[2], path[3:]
        params = coll == "params"
        if len(rest) != 1 or coll not in ("params", "batch_stats"):
            return None
        leaf = rest[0]
        kind, _, i = head.rpartition("_")
        i = int(i) if i.isdigit() else None
        if kind == "BatchNorm" and i is not None and params == (leaf in ("scale", "bias")):
            if part == "encode" and i < n:
                return _bn_leaf(f"bns.{i}", leaf, arr)
            if part == "decode" and i == 0:
                return _bn_leaf("bn_dec", leaf, chw(arr))
            if part == "decode" and i < n:
                return _bn_leaf(f"tbns.{i - 1}", leaf, arr)
            return None
        if not params or leaf not in ("kernel", "bias") or i is None:
            return None
        suffix = "weight" if leaf == "kernel" else "bias"
        if part == "encode" and kind == "Conv" and i < n:
            return f"convs.{i}.{suffix}", _conv(arr) if leaf == "kernel" else arr
        if kind == "Dense" and i == 0 and part == "encode":
            return f"fc_enc.{suffix}", chw(arr).T if leaf == "kernel" else arr
        if kind == "Dense" and i == 0 and part == "decode":
            return f"fc_dec.{suffix}", chw(arr.T) if leaf == "kernel" else chw(arr)
        if part == "decode" and kind == "ConvTranspose" and i < n:
            name = "tconv_out" if i == n - 1 else f"tconvs.{i}"
            return f"{name}.{suffix}", (arr[::-1, ::-1].transpose(2, 3, 0, 1)
                                        if leaf == "kernel" else arr)
        return None

    return _with_batches_tracked(_convert(_collections(variables, "batch_stats"), rule, "CAE"))


def lpips_state_dict(variables):
    """Flax LPIPS VGG16 variables {"params": {Conv_0 ... Conv_12}}
    (diagan_tpu/eval/lpips.py _VGGFeatures) -> the port LPIPS's state_dict
    (convs.{i}, eval/lpips.py)."""
    def rule(path, arr):
        coll, head, rest = path[0], path[1], path[2:]
        i = _indexed(head, "Conv")
        if coll != "params" or i is None or i >= 13 or rest not in (("kernel",), ("bias",)):
            return None
        if rest == ("kernel",):
            return f"convs.{i}.weight", _conv(arr)
        return f"convs.{i}.bias", arr

    return _convert({"params": variables["params"]}, rule, "LPIPS")


# --- optax Adam state -> torch Adam moments ---------------------------------
def optax_adam_moments(opt_state, bridge):
    """{"count": int, "schedule_count": int or None, "exp_avg": state_dict,
    "exp_avg_sq": state_dict} from the msgpack-restored state of optax.adam:
    `{"0": {"count", "mu", "nu"}, "1": {}}` at a constant lr, `{"0": ...,
    "1": {"count"}}` with a schedule (the mimicry trainer's linear decay,
    diagan_tpu/train/trainer.py _make_tx), whose count becomes
    "schedule_count". `bridge` maps a params tree (generator_state_dict,
    discriminator_state_dict, or a mimicry bridge wrapped to take
    {"params": tree}). Any other state raises."""
    if (set(opt_state) != {"0", "1"} or set(opt_state["1"]) not in (set(), {"count"})
            or set(opt_state["0"]) != {"count", "mu", "nu"}):
        raise ValueError(f"not an optax.adam state: keys {sorted(opt_state)}")
    adam, sched = opt_state["0"], opt_state["1"]
    return {"count": int(np.asarray(adam["count"])),
            "schedule_count": int(np.asarray(sched["count"])) if sched else None,
            "exp_avg": bridge(adam["mu"]), "exp_avg_sq": bridge(adam["nu"])}


# --- the reference's (rosinality's) StyleGAN2 -> the port ------------------
def _reference_styled_leaf(rest, arr):
    """(suffix, array) inside a reference StyledConv or ToRGB: None for an
    unknown key, (None, None) for a buffer with no counterpart."""
    if rest == "conv.weight":
        return "conv.weight", arr[0]
    if rest in ("conv.modulation.weight", "conv.modulation.bias"):
        return rest, arr
    if rest in ("conv.blur.kernel", "upsample.kernel"):
        return None, None
    if rest == "noise.weight":
        return "noise.weight", arr.reshape(())
    if rest == "activate.bias":
        return "bias", arr
    if rest == "bias":  # ToRGB's (1, 3, 1, 1)
        return "bias", arr.reshape(-1)
    return None


def _reference_generator_rule(path, arr):
    (key,) = path
    m = re.fullmatch(r"style\.(\d+)\.(weight|bias)", key)
    if m and int(m.group(1)) >= 1:  # style.0 is the parameter-free PixelNorm
        return f"mapping.layers.{int(m.group(1)) - 1}.{m.group(2)}", arr
    if key == "input.input":
        return "synthesis.input", arr
    if re.fullmatch(r"noises\.noise_\d+", key):
        return None, None
    m = re.fullmatch(r"(conv1|to_rgb1|convs\.(\d+)|to_rgbs\.(\d+))\.(.+)", key)
    if m is None:
        return None
    if m.group(2) is not None:
        k = int(m.group(2))
        layer = f"{'conv_up' if k % 2 == 0 else 'conv'}_{2 ** (k // 2 + 3)}"
    elif m.group(3) is not None:
        layer = f"to_rgb_{2 ** (int(m.group(3)) + 3)}"
    else:
        layer = m.group(1)
    rgb = layer.startswith("to_rgb")
    if (m.group(4) in ("noise.weight", "activate.bias", "conv.blur.kernel") and rgb) or (
            m.group(4) in ("bias", "upsample.kernel") and not rgb):
        return None
    hit = _reference_styled_leaf(m.group(4), arr)
    if hit is None or hit[0] is None:
        return hit
    return f"synthesis.layers.{layer}.{hit[0]}", hit[1]


def reference_generator_state_dict(sd):
    """The reference's StyleGAN2 Generator state_dict -> the port generator's."""
    return _convert(dict(sd), _reference_generator_rule, "reference generator")


_REF_D_LAYER = {"conv1": {"0.weight": "conv.weight", "1.bias": "bias"},
                "conv2": {"0.kernel": None, "1.weight": "conv.weight", "2.bias": "bias"},
                "skip": {"0.kernel": None, "1.weight": "conv.weight"}}


def _reference_discriminator_rule(path, arr):
    (key,) = path
    top = {"convs.0.0.weight": "from_rgb.conv.weight", "convs.0.1.bias": "from_rgb.bias",
           "final_conv.0.weight": "final_conv.conv.weight",
           "final_conv.1.bias": "final_conv.bias",
           "final_linear.0.weight": "final_linear.weight",
           "final_linear.0.bias": "final_linear.bias",
           "final_linear.1.weight": "out_linear.weight", "final_linear.1.bias": "out_linear.bias"}
    if key in top:
        return top[key], arr
    m = re.fullmatch(r"convs\.(\d+)\.(conv1|conv2|skip)\.(\d+\.\w+)", key)
    if m is None or int(m.group(1)) < 1 or m.group(3) not in _REF_D_LAYER[m.group(2)]:
        return None
    name = _REF_D_LAYER[m.group(2)][m.group(3)]
    if name is None:  # the fixed blur taps
        return None, None
    return f"blocks.{int(m.group(1)) - 1}.{m.group(2)}.{name}", arr


def reference_discriminator_state_dict(sd):
    """The reference's StyleGAN2 Discriminator state_dict -> the port
    discriminator's, with the zero bias of each ResBlock's skip conv."""
    out = _convert(dict(sd), _reference_discriminator_rule, "reference discriminator")
    for key in [k for k in out if k.endswith(".skip.conv.weight")]:
        out[key[: -len("weight")] + "bias"] = torch.zeros(out[key].shape[0])
    return out
