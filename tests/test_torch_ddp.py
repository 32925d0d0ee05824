"""The port's data-parallel SFF training (sstem_tpu_torch: parallel/ddp,
parallel/launch, the SFF trainers' ``build`` and ``main`` under a process
group, train/loop's rank-0 writes, the providers' and the device
degradation's rank rows, dryrun) vs the JAX package's data-parallel step
and the port's one-process steps.

The module fixture starts this file's one process group: 2 gloo ranks on
the CPU (``launch.spawn``, a file:// rendezvous in the tests' temporary
directory, a 120 s limit on the whole run), each running every case of
tests/_torch_ddp_cases.py, which imports no JAX and makes its inputs from
seeds. While the ranks run, this process makes the same inputs and
computes the JAX oracle and the port's one-process references. Float64
where a BatchNorm trains (in float32 the gradients of these train-mode BN
nets are ill-conditioned at such sizes, tests/test_torch_sff_train.py);
the interp step in float32, as it trains.
"""

import functools
import os
import sys
import threading

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from sstem_tpu import losses as jax_losses
from sstem_tpu.compat.torch_ckpt import load_torch_fusionnet
from sstem_tpu.models import FusionNet as JaxFusionNet
from sstem_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from sstem_tpu.train.trainer import TrainState as JaxTrainState
from sstem_tpu.train.trainer import make_train_step as jax_make_train_step
from sstem_tpu_torch import dryrun, losses
from sstem_tpu_torch.cli import _sff, train_fusion, train_unfolding
from sstem_tpu_torch.compat.weights import load_reference
from sstem_tpu_torch.data import providers
from sstem_tpu_torch.data.synthetic import write_triplet_tree
from sstem_tpu_torch.parallel import ddp, launch
from sstem_tpu_torch.train.device_datagen import degraded_batch

import _torch_ddp_cases as cases
from _torch_port import port_module

torch.set_num_threads(1)

WORLD = 2
NGF, K = cases.NGF, cases.K


def _write_tree(root):
    """3 triplets of 160^2 with their interp list (the clean middle
    sections stand in for interp images), an EPE valid list with its flow
    sidecar, and one unfolding config per run (batch 4, 100^2 crops to
    64^2, ngf 4): tests/test_torch_sff_train.py's tiny tree."""
    import h5py

    data = os.path.join(root, "data")
    rows = [r.split() for r in write_triplet_tree(data, 3, 160, seed=34)]
    with open(os.path.join(data, "interp_train_data.txt"), "w") as f:
        f.write("\n".join(r[1] for r in rows) + "\n")
    flow = np.random.default_rng(35).normal(0, 3, (160, 160, 2))
    with h5py.File(os.path.join(data, "flow.hdf"), "w") as f:
        f.create_dataset("flow2", data=flow.astype(np.float32))
    with open(os.path.join(data, "valid.txt"), "w") as f:
        f.write(f"{rows[0][0]} {rows[0][2]} flow.hdf\n")
    aug = {"random_fliplr": True, "random_flipud": True, "random_flipz": True,
           "random_rotation": True, "swap": False, "color_jitter": False,
           "COLOR": {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2},
           "elastic_trans": False,
           "ELASTIC": {"alpha_range": 100, "sigma": 10, "shave": 20},
           "gauss_noise": False, "GAUSS": {"gauss_mean": 0,
                                           "gauss_sigma": 0.001}}
    cfgs = {}
    for name in ("ddp", "one"):
        cfg = {"NAME": name,
               "TRAIN": {"resume": False, "if_valid": True,
                         "cache_path": os.path.join(root, "caches"),
                         "save_path": os.path.join(root, "models"),
                         "output_nc": 2, "ngf": NGF, "total_iters": 2,
                         "warmup_iters": 1, "base_lr": 1e-3, "end_lr": 1e-4,
                         "decay_iters": 100, "power": 1.5,
                         "weight_decay": 1e-4, "display_freq": 1,
                         "valid_freq": 1, "save_freq": 1, "batch_size": 4,
                         "random_seed": cases.MAIN_SEED},
               "DATA": {"folder_name": data, "train_txt": "train_data.txt",
                        "interp_train_txt": "interp_train_data.txt",
                        "valid_txt": "valid.txt", "patch_size": [100, 100],
                        "det_size": cases.DET, "AUG": aug}}
        cfgs[name] = os.path.join(root, name + ".yaml")
        with open(cfgs[name], "w") as f:
            yaml.safe_dump(cfg, f)
    return cfgs


def _jax_unfolding_step():
    """The JAX package's data-parallel step (``make_train_step(...,
    mesh=)``) of the unfolding trainer's loss on a 2-device CPU mesh, in
    float64 under SGD(1), on the unfolding case's weights and batch: (the
    gradient as params0 - params1, the new batch_stats, the loss)."""
    _, sd = cases.seeded_module("FusionNet", (6, 2, NGF), 50)
    variables = load_torch_fusionnet({k: torch.from_numpy(v)
                                      for k, v in sd.items()})
    spec = cases.case_inputs("unfolding")
    model = JaxFusionNet(output_nc=2, ngf=NGF)

    def loss_fn(params, batch_stats, batch):
        inputs, target = batch
        pred, mut = model.apply({"params": params, "batch_stats": batch_stats},
                                inputs, train=True, mutable=["batch_stats"])
        return jax_losses.l1_loss(pred, target), ({}, mut["batch_stats"])

    opt = optax.sgd(1.0)
    mesh = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    step = jax_make_train_step(loss_fn, opt, has_batch_stats=True, mesh=mesh)
    jax.config.update("jax_enable_x64", True)
    try:
        params, stats, x, flow2 = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            (variables["params"], variables["batch_stats"],
             spec["x"].transpose(0, 2, 3, 1),
             spec["flow2"].transpose(0, 2, 3, 1)))
        state = replicate(JaxTrainState.create(
            jax.tree_util.tree_map(jnp.asarray, params), opt,
            jax.tree_util.tree_map(jnp.asarray, stats)), mesh)
        new, metrics = step(state, shard_batch((jnp.asarray(x),
                                                jnp.asarray(flow2)), mesh))
        new_params, new_stats, loss = jax.device_get(
            (new.params, new.batch_stats, metrics["loss"]))
    finally:
        jax.config.update("jax_enable_x64", False)
    grads = jax.tree_util.tree_map(lambda a, b: a - b, params, new_params)
    return grads, new_stats, float(loss)


def _fusion_reference():
    """The port's one-process float64 fusion step on the global batch."""
    spec = cases.case_inputs("fusion")
    flow, unet = cases.fusion_models()
    loss = cases.sgd_step(unet, cases.fusion_loss(flow),
                          (torch.from_numpy(spec["x"]),
                           torch.from_numpy(spec["clean"])))
    return loss, cases.grads_of(unet)


def _interp_reference():
    """The one-process forward's ReLU inputs and step-1 gradient of the
    interp case on the global batch."""
    model, _ = cases.seeded_module("IFNet", (K,), 53)
    x, y = (torch.from_numpy(a) for a in cases.case_inputs("interp")["batches"][0])
    relu = cases.relu_inputs(model, x)
    losses.l1_loss(model(x), y).backward()
    return relu, {k: p.grad.numpy() for k, p in model.named_parameters()}


def _main_reference(cfg, monkeypatch):
    """The one-process ``train_unfolding.main`` on the same data path as the
    ranks: raw crops from the host with one provider thread (the pool,
    which a one-process run would load, is refused)."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setattr(train_unfolding, "Provider",
                        functools.partial(providers.Provider, num_threads=1))
    monkeypatch.setattr(providers.RawCropPairDataset, "load_pool",
                        lambda self, max_bytes=0: None)
    return train_unfolding.main(["-c", cfg, "--max-iters", "2", "--device",
                                 "cpu", "--device-datagen"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and this process's references."""
    root = str(tmp_path_factory.mktemp("ddp"))
    cfgs = _write_tree(root)
    box = {}

    def ranks():
        try:
            box["ranks"] = launch.spawn(
                cases.run_cases, WORLD, cfgs["ddp"], device="cpu",
                backend="gloo",
                init_method=f"file://{root}/pg", timeout_s=120)
        except BaseException as e:  # raised below, in the test's thread
            box["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    refs = {}
    try:
        refs["jax"] = _jax_unfolding_step()
        with pytest.MonkeyPatch.context() as mp:
            # fusion_models() gives train_fusion the plain warp: undone here
            mp.setattr(train_fusion, "serving_warp", train_fusion.serving_warp)
            refs["fusion"] = _fusion_reference()
        refs["interp"] = _interp_reference()
        with pytest.MonkeyPatch.context() as mp:
            refs["main"] = _main_reference(cfgs["one"], mp)
        m = cases.case_inputs("main")
        refs["degraded"] = degraded_batch(
            torch.from_numpy(m["clean"]), torch.from_numpy(m["interp"]),
            cases.MAIN_STEP, cases.MAIN_SEED, cases.DET)
        refs["dryrun"] = dryrun.train_step_loss("cpu",
                                                dryrun.dryrun_inputs(WORLD))
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], **refs}


def _close(label, got, want, rtol_of_max, floor=0.0):
    """|got - want| within ``rtol_of_max`` of max |want|, or ``floor``."""
    want = np.asarray(want)
    tol = max(rtol_of_max * float(np.abs(want).max()), floor)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, f"{label}: {err} > {tol}"


def test_cross_rank_batchnorm_matches_batchnorm_on_the_global_batch(run):
    """Each rank's half under DDP against ``nn.BatchNorm2d`` on the global
    batch, float64, within 1e-12: outputs, input gradients, the weight and
    bias gradients after DDP's averaging, running mean and (unbiased)
    running variance. Each rank's loss is the mean over its rows, as the
    trainers' are, so the averaged parameter gradient is the global mean
    loss's, and an input's gradient world-size times it (the all-reduce's
    backward sums the ranks'). Eval mode makes no all-reduce; a train-mode
    forward makes two (the sums, then the squared deviations)."""
    spec = cases.case_inputs("batchnorm")
    bn = torch.nn.BatchNorm2d(3).double()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(spec[name]))
    x = torch.from_numpy(spec["x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(spec["w"])).mean().backward()
    want = {"y": y.detach().numpy(), "x_grad": WORLD * x.grad.numpy()}
    with torch.no_grad():
        want["eval_y"] = bn.eval()(x).numpy()
    for rank, out in enumerate(run["ranks"]):
        got = out["batchnorm"]
        for key in ("y", "x_grad", "eval_y"):
            np.testing.assert_allclose(
                got[key], ddp.rank_rows(want[key], rank, WORLD), rtol=0,
                atol=1e-12, err_msg=f"rank {rank} {key}")
        for key, ref in (("weight_grad", bn.weight.grad),
                         ("bias_grad", bn.bias.grad),
                         ("running_mean", bn.running_mean),
                         ("running_var", bn.running_var)):
            np.testing.assert_allclose(got[key], ref.detach().numpy(), rtol=0,
                                       atol=1e-12, err_msg=f"rank {rank} {key}")
        assert got["train_all_reduces"] == 2
        assert got["eval_all_reduces"] == 0


def test_unfolding_step_matches_jax_data_parallel_step(run):
    """The unfolding step under DDP (cross-rank BN, 2 rows a rank) against
    ``sstem_tpu.train.trainer.make_train_step(..., mesh=)`` on a 2-device
    CPU mesh, float64, the same global batch and weights: each gradient
    within 1e-4 of its tensor's max (1e-12 absolute for the conv biases
    that feed a train-mode BN, whose true gradient is 0), the BN running
    statistics within 1e-10, the loss within 1e-10 relative; both ranks
    hold the same averaged gradient."""
    want_grad, want_stats, want_loss = run["jax"]
    for rank, out in enumerate(run["ranks"]):
        got = out["unfolding"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-10, atol=0)
        imported = load_torch_fusionnet({k: torch.from_numpy(v)
                                         for k, v in got["grads"].items()})
        for tree, want_tree, check in (
                (imported["params"], want_grad,
                 lambda label, have, want: _close(label, have, want, 1e-4,
                                                  1e-12)),
                (imported["batch_stats"], want_stats,
                 lambda label, have, want: np.testing.assert_allclose(
                     have, want, rtol=0, atol=1e-10, err_msg=label))):
            leaves = jax.tree_util.tree_leaves_with_path(want_tree)
            assert len(leaves) == len(jax.tree_util.tree_leaves(tree))
            for path, want in leaves:
                have = tree
                for key in path:
                    have = have[key.key]
                check(f"rank {rank} {jax.tree_util.keystr(path)}",
                      np.asarray(have), np.asarray(want))
    g0, g1 = (out["unfolding"]["grads"] for out in run["ranks"])
    for key in g0:
        assert np.array_equal(g0[key], g1[key]), key


def test_fusion_step_matches_the_one_process_step(run):
    """The fusion step under DDP (UNetSFF's BN cross-rank, the frozen flow
    net outside DDP and in eval mode) against the port's one-process
    float64 step on the global batch, which tests/test_torch_sff_train.py
    holds to JAX: the loss within 1e-12 relative, each gradient within
    1e-10 of its tensor's max (1e-12 absolute for the BN-fed conv biases,
    whose true gradient is 0)."""
    want_loss, want = run["fusion"]
    params = dict(port_module("UNetSFF", empty=True).named_parameters())
    for out in run["ranks"]:
        got = out["fusion"]
        assert not got["flow_training"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-12, atol=0)
        for key in params:
            _close(key, got["grads"][key], want[key], 1e-10, 1e-12)


def test_interp_step_matches_the_one_process_step_and_ranks_stay_equal(run):
    """The interp step (IFNet K=5, float32, 2 rows a rank) under DDP: every
    ReLU input of each rank's rows has the sign it has in the one-process
    forward of the global batch (a float32 input within rounding of 0 may
    take the other side and move a gradient by percents: ROADMAP
    "ReLU kinks"), then the averaged gradient within 1e-5 of each tensor's
    max of the one-process step's; after two Adam steps the ranks'
    parameters are bitwise equal. Two rows a rank, not one: on the CPU,
    PyTorch's float32 convolution backward of a one-row batch sums some
    weight and bias gradients of this IFNet up to 1.5e-3 of their max away
    from float64, where at two rows and more it stays within 2e-6, so a
    one-row rank would measure that kernel, not the data parallelism (the
    DDP gradient equals the mean of the one-row gradients exactly)."""
    want_relu, want = run["interp"]
    for rank, out in enumerate(run["ranks"]):
        got = out["interp"]
        assert len(got["relu"]) == len(want_relu)
        for a, b in zip(got["relu"], want_relu):
            assert np.array_equal(a > 0, ddp.rank_rows(b, rank, WORLD) > 0)
        for key, g in want.items():
            _close(f"rank {rank} {key}", got["grads"][key], g, 1e-5)
    p0, p1 = (out["interp"]["params"] for out in run["ranks"])
    for key in p0:
        assert np.array_equal(p0[key], p1[key]), key


def test_train_unfolding_main_under_the_group(run):
    """``train_unfolding.main --device-datagen --device cpu`` under the
    group, 2 steps on the tiny tree (batch 4, the raw-crop path; EPE
    validation on rank 0 at each step), against the one-process ``main``
    on the same config and seed: one run directory, its loss.txt within
    1e-5 relative, the same files, rank 1 opened nothing for writing and
    made no directory, the checkpoints hold the one-process keys (no
    ``module.`` prefix) and load strictly into FusionNet; each rank's rows
    of a degraded batch equal the one-process rows of the global batch
    exactly."""
    outs = [out["main"] for out in run["ranks"]]
    assert outs[0]["paths"] == outs[1]["paths"]
    assert outs[1]["writes"] == []
    paths, one = outs[0]["paths"], run["main"]

    def lines(p, name):
        with open(os.path.join(p["cache_path"], name)) as f:
            return f.read().splitlines()

    def loss(line):
        return float(line.split("loss = ")[1].split()[0])

    got, want = lines(paths, "loss.txt"), lines(one, "loss.txt")
    assert [ln.split(",")[0] for ln in got] == ["step 1", "step 2"]
    np.testing.assert_allclose([loss(ln) for ln in got],
                               [loss(ln) for ln in want], rtol=1e-5, atol=0)
    assert len(lines(paths, "valid.txt")) == len(lines(one, "valid.txt")) == 2
    for key in ("cache_path", "save_path"):
        assert sorted(os.listdir(paths[key])) == sorted(os.listdir(one[key]))
    ckpts = [torch.load(os.path.join(p["save_path"], "model-000002.ckpt"),
                        map_location="cpu", weights_only=True)
             for p in (paths, one)]
    assert list(ckpts[0]["model_weights"]) == list(ckpts[1]["model_weights"])
    load_reference(port_module("FusionNet", 6, 2, NGF, empty=True), ckpts[0])
    for rank, out in enumerate(outs):
        for a, b in zip(out["degraded"], run["degraded"]):
            assert np.array_equal(a, ddp.rank_rows(b.numpy(), rank, WORLD))


def test_dryrun_rank_body_matches_the_one_process_step(run):
    """``dryrun_multichip``'s rank body at world 2 on the CPU: each rank's
    loss is above 0 and equals the one-process step's within 1e-5
    relative."""
    for out in run["ranks"]:
        assert out["dryrun"] > 0
        np.testing.assert_allclose(out["dryrun"], run["dryrun"], rtol=1e-5,
                                   atol=0)


# ---------------------------------------------------------------------------
# guards (no process group)
# ---------------------------------------------------------------------------

def test_a_batch_that_does_not_divide_among_the_ranks_raises():
    """The global batch must divide among the ranks: ``local_batch_size``,
    ``rank_rows`` and ``Provider`` raise a ValueError naming both numbers."""
    with pytest.raises(ValueError, match="batch of 5 does not divide among 2"):
        ddp.local_batch_size(5, 2)
    with pytest.raises(ValueError, match="batch of 3 does not divide among 2"):
        ddp.rank_rows((np.zeros((3, 1)), np.zeros((3, 2))), 1, 2)
    with pytest.raises(ValueError, match="batch of 6 does not divide among 4"):
        providers.Provider(None, 6, seed=0, num_threads=0, rank=1, world=4)


def test_provider_rank_rows_are_the_one_process_rows():
    """With one thread, rank r's batches are rows [r B/w, (r+1) B/w) of the
    one-process provider's global batches, dict samples included."""

    class Samples:
        def sample(self, rng):
            return {"a": rng.random((1, 2)), "b": rng.integers(0, 9, (3,))}

    batches = {}
    for rank, world in ((0, 1), (0, 2), (1, 2)):
        p = providers.Provider(Samples(), 4, seed=7, num_threads=1,
                               rank=rank, world=world)
        try:
            batches[rank, world] = [p.next() for _ in range(3)]
        finally:
            p.close()
    for step, whole in enumerate(batches[0, 1]):
        for rank in range(2):
            part = batches[rank, 2][step]
            for key in whole:
                assert torch.equal(part[key], whole[key][2 * rank:2 * rank + 2])


def test_device_for_rank_and_nccl_on_a_shared_card(monkeypatch):
    """Ranks take the cards in turn and may repeat one; under nccl two
    ranks on one card raise a ValueError naming both and the card. The CPU
    stays the CPU."""
    assert ddp.device_for_rank(3, "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert ddp.device_for_rank(3, "cuda") == torch.device("cuda", 1)
    assert ddp.device_for_rank(2, "cuda", "nccl", 2) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ddp.device_for_rank(1, "cuda", "gloo", 2) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match=r"ranks 0 and 1 would share cuda:0"):
        ddp.device_for_rank(1, "cuda", "nccl", 2)
    assert ddp.default_backend("cuda:0") == "nccl"
    assert ddp.default_backend("cpu") == "gloo"


def test_data_parallel_is_the_bare_model_without_a_group():
    """A one-process run (no process group) trains the bare module, with
    its BatchNorms as they were, and reports the step's own loss."""
    model = port_module("FusionNet", 6, 2, NGF)
    assert _sff.data_parallel(model, 3, "cpu") is model
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and not any(isinstance(m, ddp.CrossRankBatchNorm2d)
                           for m in bns)
    assert ddp.world_size() == 1 and ddp.rank() == 0
    t = torch.tensor(2.5)
    assert ddp.all_mean(t) is t


def test_dryrun_entry_on_the_cpu():
    """``dryrun.entry(device='cpu')``: the IFNet K=51 forward on 1 x 6 x
    256^2 gives a finite 1 x 1 x 256^2 interp."""
    fn, args = dryrun.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (1, 1, 256, 256)
    assert torch.isfinite(out).all()
