"""The port's data tools (sstem_tpu_torch: data/sim_sff.SimuSFF,
data/sim_sp, data/validset and the CLIs simulate_sff, simulate_sp,
make_validset and gen_data_txt) vs the JAX package.

Inputs are made with numpy from seeds and go to both sides, at small sizes.
Where the code is the same numpy and cv2 the outputs must be equal; where a
float32 warp is truncated to uint8 (the SFF degradation) a value that sits
on an integer may flip a level, so those images are held to one level at a
small share of pixels, as tests/test_torch_sff_data.py holds degrade_sff.
No JAX program is compiled here beyond the warp of the JAX host simulator.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from sstem_tpu.cli import gen_data_txt as jax_gen_data_txt
from sstem_tpu.cli import make_validset as jax_make_validset
from sstem_tpu.cli import simulate_sff as jax_simulate_sff
from sstem_tpu.cli import simulate_sp as jax_simulate_sp
from sstem_tpu.data import sim_sff as jax_sim_sff
from sstem_tpu.data import sim_sp as jax_sim_sp
from sstem_tpu.data.validset import make_unfolding_validset as jax_validset
from sstem_tpu_torch.cli import (
    gen_data_txt, make_validset, simulate_sff, simulate_sp,
)
from sstem_tpu_torch.data import sim_sff, sim_sp
from sstem_tpu_torch.data.providers import SPDataset
from sstem_tpu_torch.data.synthetic import synth_stack, write_triplet_tree
from sstem_tpu_torch.data.validset import make_unfolding_validset

torch.set_num_threads(1)

SIZE = 200  # SimuSFF's crop (the noise box is up to 200 px); sections 216^2


def _level_diff(got, want):
    """(max |difference| in uint8 levels, share of pixels that differ)."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def _assert_warped_close(got, want, share=2e-3):
    """A float32 warp truncated to uint8: within 1 level at < ``share`` of
    the pixels."""
    assert got.shape == want.shape and got.dtype == want.dtype
    d, s = _level_diff(got, want)
    assert d <= 1 and s < share, (d, s)


@pytest.mark.parametrize("noise", [False, True])
def test_simusff_matches_jax(noise):
    """Same seed: the same crop, fold and noise box (the flow and mask
    exact), the degraded image within 1 level at < 0.2% of pixels; and the
    generator left in the same state."""
    img = synth_stack(1, SIZE + 16, SIZE + 16, seed=31)[0]
    for seed in range(3):
        rngs = [np.random.default_rng(seed) for _ in range(2)]
        got = sim_sff.SimuSFF(size=SIZE, apply_noise=noise)(img, rngs[0])
        want = jax_sim_sff.SimuSFF(size=SIZE, apply_noise=noise)(img, rngs[1])
        _assert_warped_close(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)
    with pytest.raises(ValueError):
        sim_sff.SimuSFF(size=SIZE)(img[:SIZE - 1], np.random.default_rng(0))


def _bank_equal(got, want):
    assert len(got) == len(want) > 0
    for field in ("masks", "mask10s", "mask01s"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_array_equal(a, b)
    assert got.areas == want.areas


@pytest.fixture(scope="module")
def banks():
    """The synthetic bank (6 blobs of 64..128 px) from both packages."""
    return (sim_sp.MaskBank.synthetic(n=6, seed=7, size_range=(64, 128)),
            jax_sim_sp.MaskBank.synthetic(n=6, seed=7, size_range=(64, 128)))


def test_mask_banks_match_jax(banks, tmp_path):
    """``synthetic`` and ``build_from_binary`` give the same triples and
    areas (a blob under 300 px is dropped on both sides); ``from_dirs``
    reads the published three-directory layout the test writes (skipping
    mask0.png and files that are not PNGs) into the same bank on both
    sides."""
    _bank_equal(*banks)
    blobs = [synth_stack(1, 48, 48, seed=s)[0] for s in range(2)]
    blobs.append(np.zeros((40, 40), np.uint8))
    blobs[-1][18:22, 18:22] = 255  # 9 px of contour area: dropped
    _bank_equal(sim_sp.MaskBank.build_from_binary(blobs),
                jax_sim_sp.MaskBank.build_from_binary(blobs))

    port_bank = banks[0]
    roots = [str(tmp_path / d) for d in ("mask", "mask10", "mask01")]
    for root in roots:
        os.makedirs(root)
        Image.fromarray(np.zeros((8, 8), np.uint8)).save(
            os.path.join(root, "mask0.png"))
        with open(os.path.join(root, "notes.txt"), "w") as f:
            f.write("not a mask\n")
    for i, (m, m10, m01) in enumerate(zip(port_bank.masks, port_bank.mask10s,
                                          port_bank.mask01s)):
        for root, a in zip(roots, (m, np.rint(m10 * 255), np.rint(m01 * 255))):
            Image.fromarray(a.astype(np.uint8)).save(
                os.path.join(root, f"mask{i + 1}.png"))
    got = sim_sp.MaskBank.from_dirs(*roots)
    _bank_equal(got, jax_sim_sp.MaskBank.from_dirs(*roots))
    assert len(got) == len(port_bank)


def test_simu_sp_matches_jax(banks):
    """Same bank and seed: the degraded section and both masks equal, and
    the generator left in the same state."""
    img = synth_stack(1, 256, 256, seed=8)[0]
    rngs = [np.random.default_rng(9) for _ in range(2)]
    got = sim_sp.simu_sp(img, banks[0], rngs[0], num_draws=40)
    want = jax_sim_sp.simu_sp(img, banks[1], rngs[1], num_draws=40)
    for a, b in zip(got, want):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert np.abs(got[0].astype(int) - img.astype(int)).max() > 10
    assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)


def test_extract_m_and_mask01_grad_mask_match_jax():
    """``extract_m`` (both thickness modes) and ``mask01_grad_mask`` equal
    JAX's on a section with dark blobs of several sizes."""
    img = np.full((200, 220), 200, np.uint8)
    yy, xx = np.mgrid[0:200, 0:220]
    for cy, cx, r, v in ((60, 60, 30, 20), (140, 150, 45, 40), (30, 190, 6, 10)):
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = v
    for select in (True, False):
        m = sim_sp.extract_m(img, if_select_masks=select)
        np.testing.assert_array_equal(
            m, jax_sim_sp.extract_m(img, if_select_masks=select))
    assert m[60, 60] == 255 and m[100, 5] == 0
    grad = sim_sp.mask01_grad_mask(m)
    np.testing.assert_array_equal(grad, jax_sim_sp.mask01_grad_mask(m))
    assert grad[100, 5] == 255 and grad[140, 150] < 255


def _tree(root, n=2, size=160, seed=13):
    rows = write_triplet_tree(root, n_triplets=n, size=size, seed=seed)
    return [r.split() for r in rows]


def _read(path):
    return np.asarray(Image.open(path))


def test_make_unfolding_validset_matches_jax(tmp_path):
    """Same rows and seed: the interp and ground-truth crops and both txt
    files equal, the degraded crops within 1 level at < 0.2% of pixels, and
    each ``flow2`` sidecar within 1e-4."""
    import h5py

    root = str(tmp_path / "tree")
    rows = _tree(root)
    outs = [str(tmp_path / d) for d in ("port", "jax")]
    got = make_unfolding_validset(root, outs[0], rows, crop=100, det=64, seed=1)
    want = jax_validset(root, outs[1], rows, crop=100, det=64, seed=1)
    assert got == want and len(got) == 2
    _compare_trees(*outs)
    with h5py.File(os.path.join(outs[0], "0000_flow.hdf"), "r") as f:
        assert f["flow2"].shape == (64, 64, 2)


def _compare_trees(got_dir, want_dir):
    """Every file of ``want_dir`` in ``got_dir``, and no other: PNGs whose
    name marks a warped image (``_SimuSFF.png`` or a valid set's degraded
    ``NNNN.png``) within 1 level at < 0.2% of pixels, other PNGs and text
    equal, HDF5 ``flow2`` within 1e-4."""
    import h5py

    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        a, b = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".hdf"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                np.testing.assert_allclose(fa["flow2"][()], fb["flow2"][()],
                                           rtol=0, atol=1e-4, err_msg=name)
        elif name.endswith("_SimuSFF.png") or name[:-4].isdigit():
            _assert_warped_close(_read(a), _read(b))
        elif name.endswith(".png"):
            np.testing.assert_array_equal(_read(a), _read(b), err_msg=name)
        else:
            assert filecmp.cmp(a, b, shallow=False), name


def _run_both(tmp_path, setup, argv):
    """``setup(root)`` writes an input tree; each package's CLI runs on its
    own copy (``{root}`` in ``argv``); returns the two trees."""
    base = str(tmp_path / "base")
    setup(base)
    roots = []
    for name, cli in (("port", argv[0]), ("jax", argv[1])):
        root = str(tmp_path / name)
        shutil.copytree(base, root)
        cli.main([a.format(root=root) for a in argv[2]])
        roots.append(root)
    return roots


def _sections(root, n=3, size=SIZE + 16, seed=33):
    os.makedirs(root, exist_ok=True)
    for i, sec in enumerate(synth_stack(n, size, size, seed=seed)):
        Image.fromarray(sec).save(os.path.join(root, f"{i:04d}.png"))
    # a section smaller than the crop is skipped
    Image.fromarray(sec[:SIZE - 8]).save(os.path.join(root, "small.png"))


@pytest.mark.parametrize("cli", ["simulate_sff", "simulate_sp",
                                 "make_validset", "gen_data_txt_sff",
                                 "gen_data_txt_sp"])
def test_clis_match_jax(cli, tmp_path):
    """Each CLI's ``main(argv)`` on copies of one input tree writes the same
    files as the JAX CLI (``_compare_trees``)."""
    if cli == "simulate_sff":
        port, jax_out = _run_both(
            tmp_path, _sections,
            (simulate_sff, jax_simulate_sff,
             ["-p", "{root}", "-s", str(SIZE), "--seed", "3"]))
        assert len([n for n in os.listdir(port) if "_SimuSFF" in n]) == 6
    elif cli == "simulate_sp":
        port, jax_out = _run_both(
            tmp_path, lambda r: _sections(r, size=160),
            (simulate_sp, jax_simulate_sp,
             ["-p", "{root}", "--synthetic-bank", "5", "--num-draws", "30",
              "--seed", "4"]))
        assert len([n for n in os.listdir(port) if "_degra" in n]) == 12
    elif cli == "make_validset":
        port, jax_out = _run_both(
            tmp_path, _tree,
            (make_validset, jax_make_validset,
             ["-f", "{root}", "-o", "{root}/valid", "--crop", "100",
              "--det", "64", "--seed", "2"]))
        port, jax_out = (os.path.join(r, "valid") for r in (port, jax_out))
    else:
        dialect = cli.rsplit("_", 1)[1]
        port, jax_out = _run_both(
            tmp_path, lambda r: os.makedirs(r),
            (gen_data_txt, jax_gen_data_txt,
             ["-f", "{root}", "-n", "7", "--dialect", dialect]))
    _compare_trees(port, jax_out)


def test_simulate_list_spdataset_chain(tmp_path):
    """The port's SP chain from clean quartets: ``simulate_sp`` degrades
    sections 2 and 3 into the tree, ``gen_data_txt --dialect sp`` lists
    it, and ``SPDataset`` reads the simulator's images and masks (the
    unrotated, unjittered sample is the files' full-size crop)."""
    tree, clean = str(tmp_path / "tree"), str(tmp_path / "clean23")
    os.makedirs(tree)
    os.makedirs(clean)
    stack = synth_stack(5, 96, 96, seed=35)
    for q in range(2):
        for j in range(4):
            name = f"{q + 1:04d}_{j + 1}.png"
            Image.fromarray(stack[q + j]).save(os.path.join(tree, name))
            if j in (1, 2):
                shutil.copy(os.path.join(tree, name), clean)
    simulate_sp.main(["-p", clean, "-o", tree, "--synthetic-bank", "4",
                      "--num-draws", "20", "--seed", "5"])
    gen_data_txt.main(["-f", tree, "-n", "2", "--dialect", "sp"])
    ds = SPDataset(tree, os.path.join(tree, "sp_train_data.txt"),
                   patch_size=96, if_rotate=False, if_bdadjust=False)
    assert len(ds) == 2
    sample = ds.get(1, np.random.default_rng(0))
    for key, name in (("img_2", "0002_2.png"), ("img_2_degra", "0002_2_degra.png"),
                      ("img_3_degra", "0002_3_degra.png"),
                      ("img_2_degraB1_mask_gradall", "0002_2_degra_maska.png"),
                      ("img_3_degraB1_GenGradMask", "0002_3_degra_maskb.png")):
        want = _read(os.path.join(tree, name)).astype(np.float32) / 255.0
        np.testing.assert_array_equal(sample[key][0], want, err_msg=key)
    np.testing.assert_array_equal(
        sample["img_3_degraB1_mask_gradall_r"][0],
        (255 - _read(os.path.join(tree, "0002_3_degra_maska.png"))).astype(
            np.float32) / 255.0)


def test_gen_list_validset_train_unfolding_chain(tmp_path, monkeypatch):
    """The port's SFF chain from a triplet tree: ``gen_data_txt --dialect
    sff`` lists it (the rows ``write_triplet_tree`` wrote), ``make_validset``
    builds the valid set beside it, ``train_unfolding.main --device cpu``
    trains a step and validates on it (a finite EPE in valid.txt), and
    ``unfolding_valid_items`` yields the files' contents (what the smoke run
    on the card, which has no h5py, validates on)."""
    import sys

    import h5py
    import yaml

    from sstem_tpu_torch.cli import _sff, train_unfolding
    from sstem_tpu_torch.data.providers import UnfoldingValidDataset, _gray6
    from sstem_tpu_torch.data.validset import unfolding_valid_items
    from sstem_tpu_torch.models import FusionNet

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    data = str(tmp_path / "data")
    rows = _tree(data, n=2)
    with open(os.path.join(data, "train_data.txt")) as f:
        written = f.read()
    gen_data_txt.main(["-f", data, "-n", "2", "--dialect", "sff"])
    with open(os.path.join(data, "train_data.txt")) as f:
        assert f.read() == written
    with open(os.path.join(data, "interp_train_data.txt"), "w") as f:
        f.write("\n".join(r[1] for r in rows) + "\n")
    make_validset.main(["-f", data, "-o", data, "--crop", "100", "--det", "64"])
    cfg = {"NAME": "unfold_chain",
           "TRAIN": {"resume": False, "if_valid": True,
                     "cache_path": str(tmp_path / "caches"),
                     "save_path": str(tmp_path / "models"),
                     "input_nc": 6, "output_nc": 2, "ngf": 4, "loss": "L1",
                     "total_iters": 1, "warmup_iters": 1, "base_lr": 1e-3,
                     "end_lr": 1e-4, "decay_iters": 100, "power": 1.5,
                     "weight_decay": 1e-4, "display_freq": 1, "valid_freq": 1,
                     "save_freq": 1, "batch_size": 2, "random_seed": 555},
           "DATA": {"folder_name": data, "train_txt": "train_data.txt",
                    "interp_train_txt": "interp_train_data.txt",
                    "valid_txt": "unfolding_valid.txt",
                    "patch_size": [100, 100], "det_size": 64,
                    "AUG": {"random_fliplr": False, "random_flipud": False,
                            "random_flipz": False, "random_rotation": False,
                            "swap": False, "color_jitter": False,
                            "COLOR": {"brightness": 0.2, "contrast": 0.2,
                                      "saturation": 0.2},
                            "elastic_trans": False,
                            "ELASTIC": {"alpha_range": 100, "sigma": 10,
                                        "shave": 20},
                            "gauss_noise": False,
                            "GAUSS": {"gauss_mean": 0, "gauss_sigma": 0.001}}}}
    path = str(tmp_path / "unfold.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    paths = train_unfolding.main(["-c", path, "--max-iters", "1",
                                  "--device", "cpu"])
    with open(os.path.join(paths["cache_path"], "valid.txt")) as f:
        epe = float(f.read().split("valid-epe=")[1].split()[0])
    assert np.isfinite(epe) and epe > 0

    items = list(unfolding_valid_items(data, rows, crop=100, det=64))
    assert len(items) == 2
    for i, item in enumerate(items):
        for suffix, key in ((".png", "degraded"), ("_interp.png", "interp"),
                            ("_gt.png", "gt")):
            np.testing.assert_array_equal(
                _read(os.path.join(data, f"{i:04d}{suffix}")), item[key])
        with h5py.File(os.path.join(data, f"{i:04d}_flow.hdf"), "r") as f:
            np.testing.assert_array_equal(f["flow2"][()], item["flow2"])
    model = FusionNet(6, 2, 4, generator=torch.Generator().manual_seed(0))
    model.eval()

    def eval_fn(x):
        with torch.no_grad():
            return model(x)

    in_memory = [(_gray6(it["degraded"], it["interp"]),
                  np.ascontiguousarray(it["flow2"].transpose(2, 0, 1)))
                 for it in items]
    assert _sff.epe_valid_loop(eval_fn, in_memory, "cpu") == _sff.epe_valid_loop(
        eval_fn, UnfoldingValidDataset(data, "unfolding_valid.txt"), "cpu")
