"""The port's quality tools (``sstem_tpu_torch/tools/quality_run.py``,
``quality_run_sp.py``, ``quality_check.py``, ``diagnose_fusion.py``)
against the JAX tools of the same names.

Where a JAX tool has a module-level function, the port's is held to it on
the same inputs: the SP quartet tree file by file, the SFF evaluation stack,
``psnr01`` and the score rows. Then each port tool runs end to end on the
CPU at the smallest sizes its CLIs take (one or two iterations a stage;
no JAX trainer runs, since a flax train-step compile costs more than this
file's budget): ``stage.json``, the report's rows and the default ``--out``
under ``--root`` are checked, and ``quality_check`` and ``diagnose_fusion
--no-curve`` run on the SFF run's root.
"""

import importlib.util
import json
import math
import os

import numpy as np
import pytest

from sstem_tpu_torch import config
from sstem_tpu_torch.tools import (
    diagnose_fusion, quality_check, quality_run, quality_run_sp,
)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
SIZE = 64  # the eval stacks' and the trees' sections
K = 5  # the KPNs' K in these runs (the tools' KERNEL_SIZE is 51)

SFF_ARGS = ["--device", "cpu", "--iters", "1", "--triplets", "2",
            "--img-size", str(SIZE), "--patch", "32", "--batch", "1",
            "--batch-correction", "2", "--stack-size", str(SIZE)]
SP_ARGS = ["--device", "cpu", "--quartets", "1", "--eval-quartets", "1",
           "--img-size", str(SIZE), "--eval-size", str(SIZE), "--patch", "32",
           "--batch", "1", "--iters-vfi", "1", "--iters-denoise", "2",
           "--iters-fusion", "1", "--bank-size", "2"]


def jax_tool(name):
    """A JAX tool module loaded from ``tools/<name>.py`` (its imports of
    the JAX package happen inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quartet_tree_matches_jax(tmp_path):
    from sstem_tpu.data.sim_sp import MaskBank as JaxBank
    from sstem_tpu_torch.data.sim_sp import MaskBank

    jax_tool("quality_run_sp")._build_quartets(
        str(tmp_path / "jax"), 1, SIZE, JaxBank.synthetic(n=2, seed=5),
        seed=11)
    quality_run_sp.build_quartets(
        str(tmp_path / "port"), 1, SIZE, MaskBank.synthetic(n=2, seed=5),
        seed=11)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 4 + 2 * 4 + 1
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_eval_stack_matches_jax():
    from sstem_tpu.data.sim_sff import degrade_sff
    from sstem_tpu.data.synthetic import synth_stack

    clean, degraded, ids, gt = quality_run.eval_stack(SIZE)
    want = synth_stack(9, SIZE, SIZE, seed=99)
    rng = np.random.default_rng(13)
    assert ids == [2, 4, 6]
    assert np.array_equal(clean, want)
    for i in ids:
        out = degrade_sff(want[i], rng, det_size=SIZE)
        want[i] = np.asarray(out["degraded"], np.uint8)
        assert np.array_equal(gt[i]["flow2"], out["flow2"])
        assert np.array_equal(gt[i]["mask"], out["mask"])
    assert np.array_equal(degraded, want)


def test_psnr01_matches_jax():
    want = jax_tool("diagnose_fusion").psnr01
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 256, (2, 16, 16)).astype(np.float64)
    pred = np.clip(gt + rng.normal(0, 9, gt.shape), 0, 255)
    region = rng.random(gt.shape) < 0.3
    for r in (None, region, ~region, np.zeros_like(region)):
        got, ref = diagnose_fusion.psnr01(gt, pred, r), want(gt, pred, r)
        assert got == ref or (math.isnan(got) and math.isnan(ref))
    assert diagnose_fusion.psnr01(gt, gt) == want(gt, gt) == 1e12


def test_score_rows_match_jax():
    from sstem_tpu.metrics import (
        calculate_psnr, calculate_ssim, compute_psnr, compute_ssim,
    )

    rng = np.random.default_rng(1)
    clean = rng.integers(0, 256, (7, 40, 40)).astype(np.uint8)
    degraded = np.clip(clean + rng.normal(0, 20, clean.shape), 0,
                       255).astype(np.uint8)
    ids = [2, 4]
    restored = {i: {k: np.clip(clean[i] + rng.normal(0, s, clean[i].shape),
                               0, 255).astype(np.uint8)
                    for k, s in (("interp", 9), ("fused", 5), ("stitch", 0))}
                for i in ids}
    rows = quality_run.score_rows(clean, degraded, restored, ids)
    images = {"degraded(baseline)": {i: degraded[i] for i in ids},
              **{k: {i: restored[i][k] for i in ids}
                 for k in quality_run.OUTPUTS}}
    for key, (p, s) in rows.items():
        ps, ss = [], []
        for i in ids:
            gt = clean[i].astype(np.float64)
            pred = images[key][i].astype(np.float64)
            q = compute_psnr(gt, pred)
            ps.append(q[1] if isinstance(q, tuple) else q)
            ss.append(compute_ssim(gt, pred))
        assert abs(p - np.mean(ps)) <= 1e-9 and abs(s - np.mean(ss)) <= 1e-9
    assert rows["stitch"][0] == 1e12

    pairs = [(clean[i].astype(np.float64),
              {"degraded": degraded[i].astype(np.float64),
               "vfi": restored[i]["interp"].astype(np.float64),
               "fused": restored[i]["fused"].astype(np.float64)})
             for i in ids]
    rows = quality_run_sp.score_rows(pairs)
    for key, (p, s) in rows.items():
        assert abs(p - np.mean([calculate_psnr(pr[key], c)
                                for c, pr in pairs])) <= 1e-9
        assert abs(s - np.mean([calculate_ssim(pr[key], c)
                                for c, pr in pairs])) <= 1e-9


def finite_table(text, rows):
    """{row: [numbers]} of a report's table; every row present, finite."""
    table = {}
    for line in text.splitlines():
        cells = [c.strip() for c in line.strip("|").split("|")]
        if line.startswith("|") and cells[0] in rows:
            table[cells[0]] = [float(c) for c in cells[1:]]
    assert sorted(table) == sorted(rows), table
    assert all(np.isfinite(v).all() for v in table.values()), table
    return table


@pytest.fixture(scope="module")
def small_kpn():
    """The tools' KPNs at K (their K=51 sepconv's plain version costs
    seconds a call on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        for tool in (quality_run, quality_run_sp, quality_check):
            mp.setattr(tool, "KERNEL_SIZE", K)
        yield


@pytest.fixture(scope="module")
def sff_root(tmp_path_factory, small_kpn):
    root = str(tmp_path_factory.mktemp("quality_run"))
    results = quality_run.main(["--root", root] + SFF_ARGS)
    return root, results


def test_quality_run_end_to_end(sff_root):
    root, results = sff_root
    assert config.matmul_precision() == "highest"
    with open(os.path.join(root, "stage.json")) as f:
        stage = json.load(f)
    assert sorted(stage) == ["cfg_i", "fusion_save", "interp_save",
                             "interp_ts", "unfold_save"]
    for key in ("interp_save", "unfold_save", "fusion_save"):
        assert os.path.exists(os.path.join(stage[key], "model-000001.ckpt"))
    for name in ("q_interp", "q_unfold", "q_fusion"):
        assert os.path.exists(os.path.join(root, f"{name}.yaml"))
    with open(os.path.join(root, "SCORES.md")) as f:
        text = f.read()
    table = finite_table(text, quality_run.ROWS)
    for key, (p32, s32, p16, s16, delta) in table.items():
        assert (p32, s32) == tuple(round(v, n) for v, n in zip(
            results["float32"][key], (3, 4)))
        assert abs(delta - (p16 - p32)) <= 1.5e-3
    assert "Worst bf16-serving PSNR delta" in text
    # the stages are resumable: a second call trains nothing
    quality_run.main(["--root", root] + SFF_ARGS)
    with open(os.path.join(root, "stage.json")) as f:
        assert json.load(f) == stage


def test_quality_check_on_the_run(sff_root, small_kpn, capsys):
    root, _ = sff_root
    with open(os.path.join(root, "stage.json")) as f:
        stage = json.load(f)
    rows = quality_check.main(
        ["--interp", stage["interp_save"], "--flow", stage["unfold_save"],
         "--fusion", stage["fusion_save"], "--size", str(SIZE),
         "--device", "cpu"])
    assert sorted(rows) == sorted(quality_check.OUTPUTS)
    assert all(np.isfinite(v).all() for v in rows.values())
    out = capsys.readouterr().out
    assert "WARNING" not in out and "stitch: max|d|=" in out
    assert config.matmul_precision() == "highest"


def test_diagnose_fusion_on_the_run(sff_root):
    root, _ = sff_root
    out = os.path.join(root, "diag.json")
    report = diagnose_fusion.main(["--root", root, "--stack-size", str(SIZE),
                                   "--no-curve", "--device", "cpu",
                                   "--out", out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    rows = report["psnr"]
    for name in ("degraded", "interp", "warped[evalflow]", "fused[evalflow]",
                 "warped[bsflow]", "fused[bsflow]", "warped[gtflow]",
                 "fused[gtflow]"):
        assert np.isfinite(rows[name]["overall"]), name
    assert 0 < rows["strip_fraction"] < 1
    for name in ("evalflow", "bsflow"):
        assert np.isfinite(list(report["epe"][name].values())).all()
    assert "curve" not in report


def test_quality_run_sp_end_to_end(tmp_path, small_kpn, monkeypatch):
    # a relative --root: the pretrained links must still resolve
    monkeypatch.chdir(tmp_path)
    rows = quality_run_sp.main(["--root", "sp"] + SP_ARGS)
    root = str(tmp_path / "sp")
    with open(os.path.join(root, "stage.json")) as f:
        stage = json.load(f)
    assert sorted(stage) == ["data", "denoise_save", "eval_data",
                             "fusion_save", "vfi_save"]
    # the pretrained directory links both branches' checkpoints
    assert sorted(os.listdir(os.path.join(root, "pretrained"))) == [
        "model-000001.ckpt", "model-000002.ckpt"]
    for name in ("pred1.png", "pred2.png", "vfi_1.png", "vfi_2.png"):
        assert os.path.exists(os.path.join(root, "eval_out", "0001", name))
    with open(os.path.join(root, "SCORES_SP.md")) as f:
        table = finite_table(f.read(), quality_run_sp.ROWS)
    for key, (p, s) in table.items():
        assert (p, s) == (round(rows[key][0], 3), round(rows[key][1], 4))
    assert config.matmul_precision() == "highest"
