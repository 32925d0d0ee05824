"""Weights into the port: JAX variables and reference checkpoints.

The ``*_state_dict_from_jax`` functions are the inverse of
``sstem_tpu/compat/torch_ckpt.py``. They take the flax variables of the JAX
model (numpy or array-like leaves) and return a state dict with the
reference's key names, which the port's module loads with
``load_state_dict(strict=True)``:

  * conv kernel (kh, kw, in, out) -> weight (out, in, kh, kw);
  * deconv kernel (kh, kw, out, in) -> weight (in, out, kh, kw);
    both are ``transpose(3, 2, 0, 1)``;
  * BN scale/bias params and mean/var stats -> weight/bias and
    running_mean/running_var (num_batches_tracked = 0).

``load_reference`` loads a checkpoint of the reference code into a port
module: it unwraps a ``model_weights`` payload and strips the ``module.``
prefix that ``nn.DataParallel`` adds.
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p):
    out = {"weight": _t(np.transpose(np.asarray(p["Conv_0"]["kernel"]), (3, 2, 0, 1)))}
    if "bias" in p["Conv_0"]:  # a conv without bias (the discriminators')
        out["bias"] = _t(p["Conv_0"]["bias"])
    return out


def _deconv(p):
    return {"weight": _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))),
            "bias": _t(p["bias"])}


def _bn(p, s):
    return {"weight": _t(p["BatchNorm_0"]["scale"]),
            "bias": _t(p["BatchNorm_0"]["bias"]),
            "running_mean": _t(s["BatchNorm_0"]["mean"]),
            "running_var": _t(s["BatchNorm_0"]["var"]),
            "num_batches_tracked": torch.tensor(0, dtype=torch.long)}


def _put(sd, prefix, entries):
    for k, v in entries.items():
        sd[f"{prefix}.{k}"] = v


# the JAX IFNet's head names -> the reference's, by n_frames
# (torch_ckpt.py::load_torch_ifnet)
_IFNET_HEADS = {
    1: (("head2h", "upconv51_1"), ("head2v", "upconv51_2"),
        ("head1h", "upconv51_3"), ("head1v", "upconv51_4")),
    2: tuple((f"{head}_f{f}", f"upconv51_{f}{i}") for f in (1, 2)
             for i, head in enumerate(("head1h", "head1v", "head2h",
                                       "head2v"), 1)),
}


def ifnet_state_dict_from_jax(variables, n_frames=1):
    """IFNet (``n_frames`` 1 or 2) flax variables -> port/reference state
    dict."""
    p = variables["params"]
    sd = {}
    for name in ["conv32", "conv64", "conv128", "conv256", "conv512",
                 "conv512x512", "upconv256", "upconv128", "upconv64"]:
        for j, idx in (("conv0", 0), ("conv1", 2), ("conv2", 4)):
            _put(sd, f"{name}.{idx}", _conv(p[name][j]))
    for name in ["upsamp512", "upsamp256", "upsamp128", "upsamp64"]:
        _put(sd, f"{name}.1", _conv(p[name]["conv"]))
    for ours, theirs in _IFNET_HEADS[n_frames]:
        for j, idx in (("conv0", 0), ("conv1", 2), ("conv2", 4), ("conv3", 7)):
            _put(sd, f"{theirs}.{idx}", _conv(p[ours][j]))
    return sd


def fusionnet_state_dict_from_jax(variables):
    """FusionNet flax variables -> port/reference state dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}

    def block(prefix, bp, bs):  # conv_block: Conv(0) BN(1) act
        _put(sd, f"{prefix}.0", _conv(bp["conv"]))
        _put(sd, f"{prefix}.1", _bn(bp["bn"], bs["bn"]))

    for name in ["down_1", "down_2", "down_3", "down_4", "bridge",
                 "up_1", "up_2", "up_3", "up_4"]:
        bp, bs = p[name], s[name]
        block(f"{name}.conv_1", bp["conv_1"], bs["conv_1"])
        c2p, c2s = bp["conv_2"], bs["conv_2"]
        block(f"{name}.conv_2.0", c2p["block0"], c2s["block0"])
        block(f"{name}.conv_2.1", c2p["block1"], c2s["block1"])
        _put(sd, f"{name}.conv_2.2", _conv(c2p["conv"]))
        _put(sd, f"{name}.conv_2.3", _bn(c2p["bn"], c2s["bn"]))
        block(f"{name}.conv_3", bp["conv_3"], bs["conv_3"])
    for name in ["deconv_1", "deconv_2", "deconv_3", "deconv_4"]:
        _put(sd, f"{name}.0", _deconv(p[name]["deconv"]))
        _put(sd, f"{name}.1", _bn(p[name]["bn"], s[name]["bn"]))
    _put(sd, "out", _conv(p["out"]))
    return sd


def unet_sff_state_dict_from_jax(variables):
    """UNetSFF flax variables -> port/reference state dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    for name in ["conv_encode1", "conv_encode2", "conv_encode3",
                 "conv_decode3", "conv_decode2"]:
        _put(sd, f"{name}.0", _conv(p[name]["conv0"]))
        _put(sd, f"{name}.1", _bn(p[name]["bn0"], s[name]["bn0"]))
        _put(sd, f"{name}.3", _conv(p[name]["conv1"]))
        _put(sd, f"{name}.4", _bn(p[name]["bn1"], s[name]["bn1"]))
        if "deconv" in p[name]:
            _put(sd, f"{name}.6", _deconv(p[name]["deconv"]))
            _put(sd, f"{name}.7", _bn(p[name]["bn2"], s[name]["bn2"]))
    for ours, theirs in (("bottleneck_conv0", "bottleneck.0"),
                         ("bottleneck_conv1", "bottleneck.3"),
                         ("final_conv0", "final_layer.0"),
                         ("final_conv1", "final_layer.3")):
        _put(sd, theirs, _conv(p[ours]))
    for ours, theirs in (("bottleneck_bn0", "bottleneck.1"),
                         ("bottleneck_bn1", "bottleneck.4"),
                         ("bottleneck_bn2", "bottleneck.7"),
                         ("final_bn0", "final_layer.1"),
                         ("final_bn1", "final_layer.4")):
        _put(sd, theirs, _bn(p[ours], s[ours]))
    _put(sd, "bottleneck.6", _deconv(p["bottleneck_deconv"]))
    return sd


def unet_sp_state_dict_from_jax(variables):
    """UNetSP or FusionNetSP flax variables (one ``backbone``) -> port/
    reference (milesial) state dict."""
    p = variables["params"]["backbone"]
    s = variables["batch_stats"]["backbone"]
    sd = {}

    def double_conv(prefix, dp, ds):
        _put(sd, f"{prefix}.0", _conv(dp["conv0"]))
        _put(sd, f"{prefix}.1", _bn(dp["bn0"], ds["bn0"]))
        _put(sd, f"{prefix}.3", _conv(dp["conv1"]))
        _put(sd, f"{prefix}.4", _bn(dp["bn1"], ds["bn1"]))

    double_conv("inc.double_conv", p["inc"], s["inc"])
    for i in range(1, 5):
        double_conv(f"down{i}.maxpool_conv.1.double_conv",
                    p[f"down{i}"]["conv"], s[f"down{i}"]["conv"])
        double_conv(f"up{i}.conv.double_conv", p[f"up{i}"]["conv"],
                    s[f"up{i}"]["conv"])
    _put(sd, "outc.conv", _conv(p["outc"]))
    return sd


def _disc_layout(kind, n_layers=3):
    """(JAX module name, port ``nn.Sequential`` prefix) of each conv and BN
    of a discriminator ``kind`` (its class name)."""
    if kind in ("Discriminator", "Discriminator2", "Discriminator3"):
        out = 9 if kind == "Discriminator" else 8  # behind the ZeroPad2d
        return (("block0_conv", "model.0"), ("block1_conv", "model.2"),
                ("block2_conv", "model.5"), ("out", f"model.{out}"))
    if kind == "NLayerDiscriminator":
        rows = [("conv0", "model.0")]
        for n in range(1, n_layers + 1):
            rows += [(f"conv{n}", f"model.{3 * n - 1}"),
                     (f"bn{n}", f"model.{3 * n}")]
        return tuple(rows) + (("out", f"model.{3 * n_layers + 2}"),)
    if kind == "PixelDiscriminator":
        return (("conv0", "net.0"), ("conv1", "net.2"), ("bn1", "net.3"),
                ("out", "net.5"))
    raise ValueError(f"unknown discriminator kind {kind!r}")


def discriminator_state_dict_from_jax(variables, kind, n_layers=3):
    """Discriminator flax variables -> the port's state dict; ``kind`` is
    the class name (``Discriminator``, ``Discriminator2``,
    ``Discriminator3``, ``NLayerDiscriminator``, ``PixelDiscriminator``),
    ``n_layers`` the PatchGAN's depth. BN statistics are taken as they are
    (flax keeps a biased running variance, PyTorch an unbiased one; a
    loaded value is used the same way by both in eval mode)."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    sd = {}
    for ours, theirs in _disc_layout(kind, n_layers):
        if ours.startswith("bn"):
            _put(sd, theirs, _bn({"BatchNorm_0": p[ours]},
                                 {"BatchNorm_0": s[ours]}))
        else:
            _put(sd, theirs, _conv({"Conv_0": p[ours]}))
    return sd


def _unused(key):
    """Reference parameters with no counterpart in the port: the SFF IFNet's
    super-resolution branch (``srconv*``) and the SP IFNet's eight unused
    kernel heads (``upconv51_15..18``, ``upconv51_25..28``)."""
    if key.startswith("srconv"):
        return True
    head = key.split(".")[0]
    return (head.startswith("upconv51_") and len(head) == 11
            and head[-2] in "12" and head[-1] in "5678")


def load_reference(module, path_or_dict):
    """Load a reference checkpoint (path or loaded payload) into a port
    module, strictly.

    A ``model_weights`` payload is unwrapped and ``module.`` prefixes are
    stripped. Reference parameters that no port module has (``_unused``:
    the IFNets' super-resolution branch and unused SP heads) are dropped;
    checkpoints that predate BatchNorm's ``num_batches_tracked`` counter get
    it as 0.
    """
    if isinstance(path_or_dict, dict):
        payload = path_or_dict
    else:
        payload = torch.load(path_or_dict, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("module."): v
          for k, v in payload.get("model_weights", payload).items()
          if not _unused(k.removeprefix("module."))}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = torch.zeros_like(v)
    module.load_state_dict(sd, strict=True)
    return module
