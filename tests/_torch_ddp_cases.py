"""The rank bodies of tests/test_torch_ddp.py, run in the processes of one
2-rank gloo group (``sstem_tpu_torch.parallel.launch.spawn``), and the
seeded inputs that the ranks and the test process both make.

This module imports neither JAX nor the test module: a spawned rank imports
it by name to unpickle ``run_cases``, and each rank asserts that JAX is not
loaded. Each case makes its weights and data from fixed seeds with numpy
(``seeded_module``, ``case_inputs``), so the ranks start at once and need
nothing from the test process but a config path; the test process makes
the same arrays for the JAX oracle and the port's one-process references.
Every result goes back as numpy arrays.
"""

import builtins
import functools
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

NGF, K = 4, 5
MAIN_SEED, MAIN_STEP, DET = 555, 7, 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy().copy()


def seeded_module(name, args, seed):
    """The port module ``name(*args)`` with its state dict filled from
    ``seed`` (drawn in module order): conv and deconv weights He-uniform
    (variance 2 / fan_in), conv biases U(+-0.05); BatchNorm weight 1 +
    N(0, 0.1), bias N(0, 0.1), running mean N(0, 0.1) and running variance
    U(0.5, 1.5), so that eval-mode BN does real work (tests/_torch_port.py
    fills the JAX trees so). An IFNet's kernel heads' last conv is scaled so
    each frame's taps sum to about 1/sqrt(2), as a trained KPN's do.
    Returns (module, its state dict as numpy arrays)."""
    from sstem_tpu_torch import models
    from sstem_tpu_torch.models.layers import skip_init

    with skip_init():
        model = getattr(models, name)(*args)
    rng = np.random.default_rng(seed)
    sd = {}
    for prefix, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            sd.update({f"{prefix}.weight": 1 + rng.normal(0, 0.1, c),
                       f"{prefix}.bias": rng.normal(0, 0.1, c),
                       f"{prefix}.running_mean": rng.normal(0, 0.1, c),
                       f"{prefix}.running_var": rng.uniform(0.5, 1.5, c),
                       f"{prefix}.num_batches_tracked": np.array(0)})
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            w = m.weight
            deconv = isinstance(m, torch.nn.ConvTranspose2d)
            fan_in = w.shape[0 if deconv else 1] * w.shape[2] * w.shape[3]
            sd[f"{prefix}.weight"] = rng.uniform(-1, 1, w.shape) * np.sqrt(
                6.0 / fan_in)
            sd[f"{prefix}.bias"] = rng.uniform(-0.05, 0.05,
                                               w.shape[1 if deconv else 0])
    if name == "IFNet":
        for head in range(1, 5):
            sd[f"upconv51_{head}.7.weight"] *= 0.02
            sd[f"upconv51_{head}.7.bias"] = (sd[f"upconv51_{head}.7.bias"]
                                             * 0.2 + 1.0 / (args[0] * 2 ** 0.5))
    sd = {k: v.astype(np.float32) if v.dtype == np.float64 else v
          for k, v in sd.items()}
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return model, sd


def case_inputs(name):
    """The seeded data of one case (numpy; channels first)."""
    rng = np.random.default_rng({"batchnorm": 40, "unfolding": 41,
                                 "fusion": 42, "interp": 43, "main": 44}[name])
    if name == "batchnorm":
        return {"x": rng.normal(0.3, 1.5, (4, 3, 5, 6)),
                "w": rng.normal(0, 1, (4, 3, 5, 6)),
                "weight": 1 + rng.normal(0, 0.1, 3),
                "bias": rng.normal(0, 0.1, 3),
                "running_mean": rng.normal(0, 0.1, 3),
                "running_var": rng.uniform(0.5, 1.5, 3)}
    if name == "unfolding":
        return {"x": rng.random((4, 6, 32, 32)),
                "flow2": rng.normal(0, 3, (4, 2, 32, 32))}
    if name == "fusion":
        x = rng.random((4, 6, 32, 32))
        x[:, 1:3] = x[:, 0:1]  # the degraded channels are one gray image
        return {"x": x, "clean": rng.random((4, 1, 32, 32))}
    if name == "interp":
        return {"batches": [(rng.random((4, 6, 32, 32), dtype=np.float32),
                             rng.random((4, 1, 32, 32), dtype=np.float32))
                            for _ in range(2)]}
    return {"clean": rng.integers(0, 256, (4, 100, 100), dtype=np.uint8),
            "interp": rng.integers(0, 256, (4, 100, 100), dtype=np.uint8)}


def grads_of(model):
    """The state dict with each parameter replaced by its gradient."""
    out = {k: _np(v) for k, v in model.state_dict().items()}
    out.update({k: _np(p.grad) for k, p in model.named_parameters()})
    return out


def sgd_step(model, loss_fn, batch):
    """One ``make_train_step`` step of ``model`` under SGD(lr 1), the
    optimizer of the JAX oracle (its parameter change is minus the
    gradient). Returns the step's loss metric."""
    from sstem_tpu_torch.train.trainer import TrainState, make_train_step

    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    _, metrics = make_train_step(loss_fn)(TrainState(model, opt), batch)
    return float(metrics["loss"])


def unfolding_loss(model, batch):
    """train_unfolding's loss: L1 on the flow."""
    from sstem_tpu_torch import losses

    return losses.l1_loss(model(batch[0]), batch[1]), {}


def fusion_models():
    """The fusion case's frozen flow net (eval mode) and U-Net, in float64,
    with train_fusion's warp taken by its plain version (serving_warp takes
    float32 only)."""
    from sstem_tpu_torch.cli import train_fusion
    from sstem_tpu_torch.ops.warp import spatial_transform

    train_fusion.serving_warp = spatial_transform
    flow, _ = seeded_module("FusionNet", (6, 2, NGF), 51)
    unet, _ = seeded_module("UNetSFF", (), 52)
    return flow.double().eval().requires_grad_(False), unet.double()


def fusion_loss(flow):
    """train_fusion's loss behind the frozen ``flow`` net."""
    from sstem_tpu_torch import losses
    from sstem_tpu_torch.cli import train_fusion

    def loss_fn(model, batch):
        return losses.l1_loss(
            train_fusion.compose_forward(flow, model, batch[0]), batch[1]), {}

    return loss_fn


def relu_inputs(model, x):
    """Every ReLU input of one forward of ``model`` on ``x``."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(_np(i[0])))
             for m in model.modules() if isinstance(m, torch.nn.ReLU)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def batchnorm_case(rank, world, cfg):
    """(a) CrossRankBatchNorm2d in float64 under DDP, on this rank's rows,
    with the trainers' local-mean loss; then its eval mode and its train
    mode, counting the all-reduces."""
    from sstem_tpu_torch.parallel import ddp

    spec = case_inputs("batchnorm")
    bn = ddp.CrossRankBatchNorm2d(spec["x"].shape[1]).double()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(_t(spec[name]))
    model = ddp.wrap(bn, "cpu")
    x, w = (_t(ddp.rank_rows(spec[k], rank, world)) for k in ("x", "w"))
    x.requires_grad_(True)
    y = model(x)
    (y * w).mean().backward()
    out = {"y": _np(y), "x_grad": _np(x.grad),
           "weight_grad": _np(bn.weight.grad), "bias_grad": _np(bn.bias.grad),
           "running_mean": _np(bn.running_mean),
           "running_var": _np(bn.running_var)}
    calls = []
    real = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    dist.all_reduce = counted
    try:
        with torch.no_grad():
            eval_y = bn.eval()(x)
            eval_calls = len(calls)
            bn.train()(x)
    finally:
        dist.all_reduce = real
    return {**out, "eval_all_reduces": eval_calls,
            "train_all_reduces": len(calls) - eval_calls, "eval_y": _np(eval_y)}


def unfolding_case(rank, world, cfg):
    """(b) The unfolding trainer's step (FusionNet, L1 on the flow) in
    float64 under DDP with cross-rank BatchNorm, on this rank's rows."""
    from sstem_tpu_torch.cli import _sff
    from sstem_tpu_torch.parallel import ddp

    spec = case_inputs("unfolding")
    bare = seeded_module("FusionNet", (6, 2, NGF), 50)[0].double()
    model = _sff.data_parallel(bare, spec["x"].shape[0], "cpu")
    batch = tuple(_t(ddp.rank_rows(spec[k], rank, world))
                  for k in ("x", "flow2"))
    loss = sgd_step(model, unfolding_loss, batch)
    return {"loss": loss, "grads": grads_of(bare)}


def fusion_case(rank, world, cfg):
    """(c) The fusion trainer's step (frozen flow net, warp, UNetSFF) in
    float64 under DDP, the U-Net's BatchNorms cross-rank and the flow net
    outside DDP, on this rank's rows."""
    from sstem_tpu_torch.cli import _sff
    from sstem_tpu_torch.parallel import ddp

    spec = case_inputs("fusion")
    flow, unet = fusion_models()
    model = _sff.data_parallel(unet, spec["x"].shape[0], "cpu")
    batch = tuple(_t(ddp.rank_rows(spec[k], rank, world))
                  for k in ("x", "clean"))
    loss = sgd_step(model, fusion_loss(flow), batch)
    return {"loss": loss, "grads": grads_of(unet),
            "flow_training": flow.training}


def interp_case(rank, world, cfg):
    """(d) The interp step (IFNet K=5, L1, Adam) in float32 under DDP: the
    ReLU inputs of this rank's rows, the averaged gradient of step 1, and
    the parameters after two steps."""
    from sstem_tpu_torch import losses
    from sstem_tpu_torch.cli import _sff
    from sstem_tpu_torch.parallel import ddp
    from sstem_tpu_torch.train.trainer import (
        TrainState, make_optimizer, make_train_step,
    )

    spec = case_inputs("interp")
    bare, _ = seeded_module("IFNet", (K,), 53)
    batches = [tuple(_t(ddp.rank_rows(a, rank, world)) for a in b)
               for b in spec["batches"]]
    relu = relu_inputs(bare, batches[0][0])
    model = _sff.data_parallel(bare, spec["batches"][0][0].shape[0], "cpu")
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda step: 1e-3))
    step = make_train_step(lambda m, b: (losses.l1_loss(m(b[0]), b[1]), {}))
    state, _ = step(state, batches[0])
    grads = {k: _np(p.grad) for k, p in bare.named_parameters()}
    state, _ = step(state, batches[1])
    return {"relu": relu, "grads": grads,
            "params": {k: _np(p) for k, p in bare.named_parameters()}}


def _spy_writes(record):
    """Wrap ``open`` and ``os.makedirs`` to record every path opened for
    writing or made; returns the function that restores them."""
    real_open, real_makedirs = builtins.open, os.makedirs

    def spy_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            record.append(str(file))
        return real_open(file, mode, *args, **kwargs)

    def spy_makedirs(name, *args, **kwargs):
        record.append(str(name))
        return real_makedirs(name, *args, **kwargs)

    builtins.open, os.makedirs = spy_open, spy_makedirs

    def restore():
        builtins.open, os.makedirs = real_open, real_makedirs

    return restore


def main_case(rank, world, cfg):
    """(e) ``train_unfolding.main --device-datagen --device cpu`` under the
    group on the config at ``cfg`` (the host streams raw crops; one provider
    thread, so that the batches are the one-process run's), with every path
    that rank 1 opens for writing or makes recorded; then
    ``degraded_batch`` of this rank's rows of a seeded global crop batch."""
    from sstem_tpu_torch.cli import train_unfolding
    from sstem_tpu_torch.data.providers import Provider
    from sstem_tpu_torch.parallel import ddp
    from sstem_tpu_torch.train.device_datagen import degraded_batch

    sys.modules["tensorboardX"] = None
    train_unfolding.Provider = functools.partial(Provider, num_threads=1)
    writes = []
    restore = _spy_writes(writes) if rank else (lambda: None)
    try:
        paths = train_unfolding.main(["-c", cfg, "--max-iters", "2",
                                      "--device", "cpu", "--device-datagen"])
    finally:
        restore()
    spec = case_inputs("main")
    clean, interp = (_t(ddp.rank_rows(spec[k], rank, world))
                     for k in ("clean", "interp"))
    rows = degraded_batch(clean, interp, MAIN_STEP, MAIN_SEED, DET)
    return {"paths": paths, "writes": writes,
            "degraded": [_np(t) for t in rows]}


def dryrun_case(rank, world, cfg):
    """(f) The dry run's rank body."""
    from sstem_tpu_torch import dryrun

    return dryrun._rank_step(rank, world, "cpu", dryrun.dryrun_inputs(world))


CASES = {"batchnorm": batchnorm_case, "unfolding": unfolding_case,
         "fusion": fusion_case, "interp": interp_case, "main": main_case,
         "dryrun": dryrun_case}


def run_cases(rank, world, device, cfg):
    """Every case on this rank, in one order on every rank (``cfg``: the
    main case's unfolding config). Returns {name: result}."""
    assert "jax" not in sys.modules, "a rank imported JAX"
    torch.set_num_threads(1)
    out = {name: case(rank, world, cfg) for name, case in CASES.items()}
    assert "jax" not in sys.modules, "a rank imported JAX"
    return out
