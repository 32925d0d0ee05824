"""The port's SFF correction data path (sstem_tpu_torch: losses.epe and its
family, ops/pad.negative_pad_2d, ops/warp.image_warp, ops/flow.gen_flow,
data/sim_sff, the SFF pair datasets of data/providers, and the
deterministic parts of train/device_datagen) vs the JAX package.

Inputs are made with numpy from seeds and go to both sides, at the JAX
end-to-end tests' tiny sizes (100^2 crops to 64^2). Each test states its
tolerance. torch generators cannot reproduce jax.random, so the device
path is held at given fold parameters and crop indices, and its draws by
their ranges. No JAX model is compiled here.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sstem_tpu import losses as jax_losses
from sstem_tpu.data import providers as jax_providers
from sstem_tpu.data import sim_sff as jax_sim_sff
from sstem_tpu.ops.flow import gen_flow as jax_gen_flow
from sstem_tpu.ops.pad import negative_pad_2d as jax_negative_pad_2d
from sstem_tpu.ops.warp import image_warp as jax_image_warp
from sstem_tpu_torch import losses
from sstem_tpu_torch.data import providers, sim_sff
from sstem_tpu_torch.data.synthetic import synth_stack, write_triplet_tree
from sstem_tpu_torch.ops import gen_flow, image_warp, negative_pad_2d
from sstem_tpu_torch.train import device_datagen

torch.set_num_threads(1)

# the JAX functions compiled whole, once a shape (eager dispatch compiles
# each of their ops apart)
jax_gen_flow_jit = jax.jit(jax_gen_flow, static_argnums=(0, 1))
jax_image_warp_jit = jax.jit(jax_image_warp, static_argnums=2)

CROP, DET = 100, 64
# fold parameters (k, b, line_width, fold_width, dis_k) on a 100^2 crop:
# both slopes' signs, a horizontal and a near-vertical line, a fold strip
# wider than the crop's centre
FOLDS = ((0.7, 10.0, 5.0, 30.0, 0.05), (-2.3, 180.0, 8.0, 40.0, 0.01),
         (0.0, 47.5, 20.0, 21.0, 0.1), (1e9, -5e10, 12.0, 60.0, 0.03),
         (0.25, 40.0, 50.0, 80.0, 1e-5))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 triplets of 160^2 as PNGs, an interp list (the clean middle
    sections stand in for the interp images), and valid lists with their
    ground truth (flow2 as HDF5 sidecars)."""
    import h5py
    from PIL import Image

    root = str(tmp_path_factory.mktemp("sff_tree"))
    rows = write_triplet_tree(root, n_triplets=3, size=160, seed=21)
    with open(os.path.join(root, "interp_train_data.txt"), "w") as f:
        f.write("\n".join(r.split()[2] for r in rows) + "\n")
    rng = np.random.default_rng(22)
    for i, r in enumerate(rows[:2]):
        flow = rng.normal(0, 3, (160, 160, 2)).astype(np.float32)
        with h5py.File(os.path.join(root, f"{i:04d}_flow.hdf"), "w") as f:
            f.create_dataset("flow2", data=flow)
    Image.fromarray(synth_stack(1, 160, 160, seed=23)[0]).save(
        os.path.join(root, "gt.png"))
    with open(os.path.join(root, "valid_unfolding.txt"), "w") as f:
        f.write("\n".join(f"{r.split()[0]} {r.split()[2]} {i:04d}_flow.hdf"
                          for i, r in enumerate(rows[:2])) + "\n")
    with open(os.path.join(root, "valid_fusion.txt"), "w") as f:
        f.write("\n".join(f"{r.split()[0]} {r.split()[2]} gt.png"
                          for r in rows[:2]) + "\n")
    return root


# ---------------------------------------------------------------------------
# items 1-4: the EPE family, negative_pad_2d, image_warp, gen_flow
# ---------------------------------------------------------------------------

def _flows(seed, shape=(2, 16, 24, 2)):
    rng = np.random.default_rng(seed)
    pred = rng.normal(0, 2, shape).astype(np.float32)
    target = rng.normal(0, 2, shape).astype(np.float32)
    h, w = shape[1:3]
    target[:, :h // 4, :w // 4] = 0.0  # invalid (sparse) pixels
    target[:, h // 2, w // 4:, 1] = 0.0  # one component 0 only: still valid
    return pred, target


@pytest.mark.parametrize("fn", ["epe", "sparse_max_pool", "multiscale_epe",
                                "real_epe"])
def test_epe_family_matches_jax(fn):
    """Every variant (sparse or not, mean or not, the pyramid's levels, the
    resize) within 1e-6 relative: float32 sums in another order."""
    pred, target = _flows(11)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    tp, tt = _t(pred), _t(target)
    cases = []
    if fn == "epe":
        for sparse in (False, True):
            for mean in (False, True):
                cases.append((losses.epe(tp, tt, sparse, mean),
                              jax_losses.epe(jp, jt, sparse, mean)))
    elif fn == "sparse_max_pool":
        for size in ((8, 12), (4, 6), (16, 24)):
            cases.append((losses.sparse_max_pool(tt, size),
                          jax_losses.sparse_max_pool(jt, size)))
            cases.append((losses._area_downsample(tt, size),
                          jax_losses._area_downsample(jt, size)))
    elif fn == "multiscale_epe":
        outs = [_flows(12 + i, (2, 16 >> i, 24 >> i, 2))[0] for i in range(3)]
        w = [0.32, 0.08, 0.02]
        for sparse in (False, True):
            cases.append((
                losses.multiscale_epe([_t(o) for o in outs], tt, w, sparse),
                jax_losses.multiscale_epe([jnp.asarray(o) for o in outs], jt,
                                          w, sparse)))
        cases.append((losses.multiscale_epe(tp, tt, [1.0]),
                      jax_losses.multiscale_epe(jp, jt, [1.0])))
    else:
        small = _flows(15, (2, 8, 12, 2))[0]
        for p in (small, pred):
            for sparse in (False, True):
                cases.append((losses.real_epe(_t(p), tt, sparse),
                              jax_losses.real_epe(jnp.asarray(p), jt, sparse)))
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("pad", [0, 3])
def test_negative_pad_matches_jax(pad):
    """The crop of NCHW's trailing dims equals JAX's crop of NHWC's spatial
    dims, exactly; a crop that eats the patch is refused on both sides."""
    x = np.random.default_rng(16).random((2, 3, 12, 10), dtype=np.float32)
    got = negative_pad_2d(_t(x), pad).numpy()
    want = np.asarray(jax_negative_pad_2d(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                          pad)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got, want)
    for bad in (-1, 5):
        with pytest.raises(ValueError):
            negative_pad_2d(_t(x), bad)
        with pytest.raises(ValueError):
            jax_negative_pad_2d(jnp.asarray(x.transpose(0, 2, 3, 1)), bad)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_image_warp_matches_jax(mode):
    """The edge-clamped warp on the 0..255 scale, two channels, with flows
    that leave the image on every side: within 1e-4 abs (the weights are
    the same float32 values; the sum's order may differ)."""
    rng = np.random.default_rng(17)
    im = rng.integers(0, 256, (2, 30, 41, 2)).astype(np.float32)
    flow = rng.normal(0, 12, (2, 30, 41, 2)).astype(np.float32)
    flow[0, :3] = -60.0
    flow[1, -3:] = 60.0
    got = image_warp(_t(im), _t(flow), mode).numpy()
    want = np.asarray(jax_image_warp_jit(jnp.asarray(im), jnp.asarray(flow),
                                         mode))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        image_warp(_t(im), _t(flow), "cubic")


def test_gen_flow_matches_jax_batched():
    """All FOLDS in one batched pass against JAX's gen_flow one at a time:
    flow and flow2 within 1e-4 abs; the mask exact except where |d| lies
    within 1e-4 of line_width (float32 distances): 200 such pixels here, the
    near-vertical fold's two columns at |d| = 12 exactly."""
    params = [torch.tensor(p, dtype=torch.float32) for p in zip(*FOLDS)]
    flow, flow2, mask = gen_flow(CROP, CROP, *params)
    assert flow.shape == (len(FOLDS), CROP, CROP, 2)
    assert mask.shape == (len(FOLDS), CROP, CROP)
    gx, gy = np.meshgrid(np.arange(CROP), np.arange(CROP))
    near = 0
    for i, (k, b, lw, fw, dk) in enumerate(FOLDS):
        jf, jf2, jm = jax_gen_flow_jit(CROP, CROP, k, b, lw, fw, dk)
        np.testing.assert_allclose(flow[i].numpy(), np.asarray(jf), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(flow2[i].numpy(), np.asarray(jf2),
                                   atol=1e-4, rtol=0)
        k64, b64 = np.float64(np.float32(k)), np.float64(np.float32(b))
        d = np.abs((k64 * gx - gy + b64) / np.sqrt(k64 ** 2 + 1))
        edge = np.abs(d - lw) <= 1e-4
        near += int(edge.sum())
        assert np.array_equal(mask[i].numpy()[~edge], np.asarray(jm)[~edge])
    assert near == 200
    # 0-d parameters give one fold's (H, W, 2)
    one = gen_flow(CROP, CROP, *FOLDS[0])[0]
    np.testing.assert_array_equal(one.numpy(), flow[0].numpy())


# ---------------------------------------------------------------------------
# items 5-6: the host degradation and the SFF pair datasets
# ---------------------------------------------------------------------------

def _level_diff(got, want):
    """(max |difference| in uint8 levels, share of pixels that differ)."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def test_degrade_sff_matches_jax():
    """Same numpy seed: the same fold parameters (exact), degraded uint8
    crops within 1 level at < 0.1% of pixels (float32 warps truncated to
    uint8: a value on an integer may flip a level), flow2 within 1e-4."""
    img = synth_stack(1, CROP, CROP, seed=18)[0]
    for seed in range(4):
        got = sim_sff.degrade_sff(img, np.random.default_rng(seed), DET)
        want = jax_sim_sff.degrade_sff(img, np.random.default_rng(seed), DET)
        assert got["params"] == want["params"]
        assert got["degraded"].shape == (DET, DET)
        d, share = _level_diff(got["degraded"], want["degraded"])
        assert d <= 1 and share < 1e-3, (seed, d, share)
        np.testing.assert_allclose(got["flow2"], want["flow2"], atol=1e-4,
                                   rtol=0)
        np.testing.assert_array_equal(got["mask"], want["mask"])


@pytest.mark.parametrize("kind", ["unfolding", "fusion", "raw_pairs"])
def test_sff_datasets_match_jax(tree, kind):
    """Same seed: the port's samples (channels first) are the JAX package's
    (channels last), and so are a one-thread Provider's batches: interp
    channels, clean labels and raw crops exact; degraded channels within 1
    level at < 0.1% of pixels; flow2 within 1e-4."""
    aug = dict(color_jitter=True)
    if kind == "raw_pairs":
        make = (providers.RawCropPairDataset,
                jax_providers.RawCropPairDataset)
        kw = dict(crop_size=CROP)
    else:
        make = ((providers.UnfoldingTrainDataset,
                 jax_providers.UnfoldingTrainDataset) if kind == "unfolding"
                else (providers.FusionTrainDataset,
                      jax_providers.FusionTrainDataset))
        kw = dict(crop_size=CROP, det_size=DET, gt_line=kind == "fusion")
    ours = make[0](tree, "train_data.txt", "interp_train_data.txt",
                   aug=providers.AugConfig(**aug), **kw)
    theirs = make[1](tree, "train_data.txt", "interp_train_data.txt",
                     aug=jax_providers.AugConfig(**aug), **kw)

    def check(a, b):
        if kind == "raw_pairs":
            for x, y in zip(a, b):
                assert x.dtype == np.uint8 and np.array_equal(x, y)
            return
        im, lb = a
        jim, jlb = b
        jim = np.moveaxis(jim, -1, -3)
        assert np.array_equal(im[..., 3:, :, :], jim[..., 3:, :, :])
        d, share = _level_diff(np.rint(im[..., :3, :, :] * 255),
                               np.rint(jim[..., :3, :, :] * 255))
        assert d <= 1 and share < 1e-3, (d, share)
        np.testing.assert_allclose(lb, np.moveaxis(jlb, -1, -3), atol=1e-4,
                                   rtol=0)

    r1, r2 = np.random.default_rng(19), np.random.default_rng(19)
    for _ in range(2):
        a, b = ours.sample(r1), theirs.sample(r2)
        if kind != "raw_pairs":
            want_lb = (2, DET, DET) if kind == "unfolding" else (1, DET, DET)
            assert a[0].shape == (6, DET, DET) and a[1].shape == want_lb
        check(a, b)
    prov = providers.Provider(ours, 2, seed=3, num_threads=1)
    jprov = jax_providers.Provider(theirs, 2, seed=3, num_threads=1,
                                   device_put=False)
    try:
        got, want = prov.next(), jprov.next()
        check(tuple(t.numpy() for t in got), want)
    finally:
        prov.close()
        jprov.close()
    if kind == "raw_pairs":
        pool = ours.load_pool()
        assert pool.shape == (3, 2, 160, 160) and pool.dtype == np.uint8
        np.testing.assert_array_equal(pool, theirs.load_pool())
        assert ours.load_pool(max_bytes=1000) is None


def test_valid_datasets_and_interp_pool_match_jax(tree):
    """The map-style valid sets (flow2 from its HDF5 sidecar) and the interp
    triplet pool equal the JAX package's, channels first."""
    for ours, theirs in (
            (providers.UnfoldingValidDataset(tree, "valid_unfolding.txt"),
             jax_providers.UnfoldingValidDataset(tree, "valid_unfolding.txt")),
            (providers.FusionValidDataset(tree, "valid_fusion.txt"),
             jax_providers.FusionValidDataset(tree, "valid_fusion.txt"))):
        assert len(ours) == len(theirs) == 2
        for i in range(2):
            for a, b in zip(ours[i], theirs[i]):
                np.testing.assert_array_equal(a, np.moveaxis(b, -1, 0))
    pool = providers.InterpTrainDataset(tree).load_pool()
    assert pool.shape == (3, 3, 160, 160)
    np.testing.assert_array_equal(
        pool, jax_providers.InterpTrainDataset(tree).load_pool())


# ---------------------------------------------------------------------------
# items 14-15: the device path's deterministic parts, and its draws
# ---------------------------------------------------------------------------

def _jax_degrade_with_params(images, params, det, min_zero):
    """degrade_sff_batch_jax's candidate synthesis and selection, restated
    on JAX's own gen_flow and image_warp at given fold parameters."""
    off = (images.shape[1] - det) // 2
    sl = slice(off, off + det)
    degs, flows = [], []
    for i, img in enumerate(images):
        ds, fs, counts = [], [], []
        for k, b, lw, fw, dk in zip(*[p[i] for p in params]):
            flow, flow2, mask = jax_gen_flow_jit(img.shape[0], img.shape[1],
                                                 k, b, lw, fw, dk)
            warped = jax_image_warp_jit(
                jnp.asarray(img[None, :, :, None], jnp.float32), flow[None],
                "bilinear")[0, :, :, 0]
            deformed = (jnp.floor(jnp.clip(warped, 0, 255)) * mask)[sl, sl]
            ds.append(np.asarray(deformed))
            fs.append(np.asarray(flow2[sl, sl]))
            counts.append(int((ds[-1] == 0).sum()))
        valid = [c >= min_zero for c in counts]
        idx = valid.index(True) if any(valid) else int(np.argmax(counts))
        degs.append(ds[idx])
        flows.append(fs[idx])
    return np.stack(degs), np.stack(flows)


def test_device_degradation_matches_jax_at_given_params():
    """degrade_with_params (all candidates in one batched pass) against the
    JAX device path's synthesis at the same fold parameters, 3 candidates
    for each of 2 images, JAX compiled as its device path runs: the same
    candidates selected (flow2 within 1e-4, which tells the candidates
    apart), the degraded crops within 1 level at < 0.2% of pixels (at most
    10 of 8192 here, 3 with JAX run op by op: gen_flow's float32
    trigonometry differs from XLA's by an ulp or two, and a float32 warp
    truncated to uint8 flips where it sits on an integer); with a min_zero
    no candidate meets, the fallback (the most zero pixels) likewise."""
    images = synth_stack(2, CROP, CROP, seed=20)
    folds = np.array(FOLDS[:3] + FOLDS[2:], np.float32)  # (6, 5)
    params = [folds[:, i].reshape(2, 3) for i in range(5)]
    for min_zero in (100, CROP * CROP):
        got = sim_sff.degrade_with_params(
            _t(images), [_t(p) for p in params], DET, min_zero)
        want = _jax_degrade_with_params(images, params, DET, min_zero)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-4, rtol=0)
        d, share = _level_diff(got[0].numpy(), want[0])
        assert d <= 1 and share < 2e-3, (min_zero, d, share)


def test_device_draws_are_in_range_and_keyed_by_step():
    """The fold draws cover the host sampler's ranges; a step's batch
    depends only on (seed, step): the same pair gives the same degraded
    batch, another step another one."""
    gen = sim_sff.step_generator(5, 1, "cpu")
    k, b, lw, fw, dk = sim_sff.sample_fold_params_batch(gen, 4000, CROP, CROP)
    assert lw.min() == 5 and lw.max() == 50
    assert (fw >= lw + 1).all() and fw.max() <= 80
    assert (dk >= 1e-5).all() and (dk < 0.1).all()
    assert torch.isfinite(k).all() and torch.isfinite(b).all()
    images = _t(synth_stack(2, CROP, CROP, seed=24))
    out = [sim_sff.degrade_sff_batch(images, sim_sff.step_generator(5, s, "cpu"),
                                     DET) for s in (1, 1, 2)]
    assert out[0][0].shape == (2, DET, DET) and out[0][1].shape == (2, DET, DET, 2)
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert not torch.equal(out[0][0], out[2][0])


def _jax_dihedral(x, r):
    """The JAX device path's dihedral transform (``_dihedral_jax``): rot90 by
    r % 4 over the last two axes, then a flip of the last when r >= 4."""
    x = jnp.rot90(x, k=r % 4, axes=(-2, -1))
    return jnp.flip(x, axis=-1) if r >= 4 else x


def test_pool_crops_and_dihedral_match_jax():
    """crop_pool at given crop indices and each of the 8 transforms equals
    JAX's dynamic_slice and jnp.rot90 / jnp.flip exactly; so does _dihedral
    on a (F, H, W) crop; sample_pool_crops draws within the pool."""
    rng = np.random.default_rng(25)
    pool = rng.integers(0, 256, (3, 2, 40, 36), dtype=np.uint8)
    idx, oy, ox = np.array([0, 2, 1, 1, 0, 2, 1, 0]), rng.integers(
        0, 40 - 20 + 1, 8), rng.integers(0, 36 - 20 + 1, 8)
    r = np.arange(8)
    got = device_datagen.crop_pool(_t(pool), _t(idx), _t(oy), _t(ox), _t(r), 20)
    assert got.dtype == torch.float32 and got.shape == (8, 2, 20, 20)
    jpool = jnp.asarray(pool, jnp.float32)
    for i in range(8):
        c = jax.lax.dynamic_slice(jpool, (int(idx[i]), 0, int(oy[i]),
                                          int(ox[i])), (1, 2, 20, 20))[0]
        want = np.asarray(_jax_dihedral(c, int(r[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(
            device_datagen._dihedral(torch.tensor(np.asarray(c)), int(r[i])
                                     ).numpy(), want)
    crops = device_datagen.sample_pool_crops(
        _t(pool), sim_sff.step_generator(0, 1, "cpu"), 4, 20)
    assert crops.shape == (4, 2, 20, 20)
    assert crops.min() >= 0 and crops.max() <= 255
