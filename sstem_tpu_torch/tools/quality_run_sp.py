"""Self-trained SP (stain-precipitate) quality run (counterpart of
``tools/quality_run_sp.py``).

Trains the SP chain through the port's CLIs (VFI interp, the two-frame
KPN; correction, the denoise U-Net; joint fusion) on SimuSP-degraded
synthetic quartets, then restores fresh degraded quartets with the
``test_sp_fusion`` and ``test_sp_interp`` CLIs and reports the reference's
own SP metrics (cv2-dialect ``calculate_psnr`` / ``calculate_ssim``,
sp_scripts_train/utils/util.py:134-186) for the degraded, vfi-only and
fused outputs of sections 2 and 3.

    python -m sstem_tpu_torch.tools.quality_run_sp [--root DIR]
        [--quartets 60] [--iters-vfi 6000] [--iters-denoise 3000]
        [--iters-fusion 3000] [--device cuda|cpu] [--out FILE]

Everything runs under ``set_matmul_precision("default")``, as the JAX tool
does. Stages are resumable (``<root>/stage.json``). The trees, configs,
checkpoints, outputs and the report (``--out``, by default
``<root>/SCORES_SP.md``) go under ``--root`` (by default
``build/quality_run_sp`` in the checkout).
"""

import argparse
import json
import os

import numpy as np
import yaml

DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "quality_run_sp")
KERNEL_SIZE = 51  # the VFI KPN's K, as the JAX tool writes it
ROWS = ("degraded", "vfi", "fused")


def build_quartets(folder, n, size, bank, seed, start_stem=1):
    """Write ``n`` quartets (``stem_1..4.png``), sections 2 and 3 degraded
    by the SP simulator with their masks, interp placeholders, and the
    12-column txt; the JAX tool's file names and draw order."""
    from PIL import Image

    from sstem_tpu_torch.data.providers import write_sp_txt
    from sstem_tpu_torch.data.sim_sp import simu_sp
    from sstem_tpu_torch.data.synthetic import synth_stack

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for q in range(n):
        stem = str(start_stem + q).zfill(4)
        stack = synth_stack(4, size, size, seed=seed * 100_000 + q)
        for j in range(4):
            Image.fromarray(stack[j]).save(
                os.path.join(folder, f"{stem}_{j + 1}.png"))
        for j in (2, 3):
            degra, maska, maskb = simu_sp(stack[j - 1], bank, rng,
                                          num_draws=200)
            Image.fromarray(degra).save(
                os.path.join(folder, f"{stem}_{j}_degra.png"))
            Image.fromarray(maska).save(
                os.path.join(folder, f"{stem}_{j}_degra_maska.png"))
            Image.fromarray(maskb).save(
                os.path.join(folder, f"{stem}_{j}_degra_maskb.png"))
            # interp placeholders: the rows list them; the dataset reads
            # them only with if_use_vfiImg
            Image.fromarray(stack[j - 1]).save(
                os.path.join(folder, f"{stem}_{j}_interp.png"))
    write_sp_txt(folder, n)


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--quartets", type=int, default=60)
    ap.add_argument("--eval-quartets", type=int, default=4)
    ap.add_argument("--img-size", type=int, default=320)
    ap.add_argument("--eval-size", type=int, default=512)
    ap.add_argument("--patch", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--iters-vfi", type=int, default=6000)
    ap.add_argument("--iters-denoise", type=int, default=3000)
    ap.add_argument("--iters-fusion", type=int, default=3000)
    ap.add_argument("--bank-size", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None,
                    help="the report (default <root>/SCORES_SP.md)")
    return ap


def write_config(root, name, args, extra):
    """The flat SP YAML of one stage, ``<root>/<name>.yaml``, as the JAX
    tool writes it; returns its path."""
    data = os.path.join(root, "data")
    cfg = {
        "data_folder": data + "/",
        "data_txt": os.path.join(data, "sp_train_data.txt"),
        "mode": "a", "patch_size": args.patch, "if_rotate": True,
        "if_bdadjust": False, "if_use_vfiImg": False,
        "batch_size": args.batch, "kernel_size": KERNEL_SIZE,
        "base_lr": args.lr, "PAD": 0,
        "n_epochs": 1, "save_freq": 2000, "valid_freq": 500,
        "cache_path": os.path.join(root, "caches"),
        "save_path": os.path.join(root, "models"),
        "random_seed": 7, "cuda": False,
        **extra,
    }
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def score_rows(images):
    """{row: (mean PSNR, mean SSIM)} of ``images``, a list of (clean,
    {row: prediction}) pairs of float64 arrays, with the reference's
    ``calculate_psnr`` / ``calculate_ssim``."""
    from sstem_tpu_torch.metrics import calculate_psnr, calculate_ssim

    rows = {}
    for key in ROWS:
        ps = [calculate_psnr(pred[key], clean) for clean, pred in images]
        ss = [calculate_ssim(pred[key], clean) for clean, pred in images]
        rows[key] = (float(np.mean(ps)), float(np.mean(ss)))
    return rows


def report(args, rows):
    """The report's lines (the JAX tool's table and wording) and its JSON
    summary."""
    lines = [
        "# SCORES_SP — self-trained SP restoration quality",
        "",
        f"SP chain trained through the real CLIs (VFI {args.iters_vfi} /"
        f" denoise {args.iters_denoise} / joint fusion {args.iters_fusion}"
        f" iters, K={KERNEL_SIZE}, patch {args.patch}^2,"
        f" batch {args.batch},"
        f" lr {args.lr:g}, LR weights vfi 1e-20 / denoise 1e-6) on"
        f" {args.quartets} SimuSP-degraded synthetic {args.img_size}^2"
        f" quartets; restoration of {args.eval_quartets} fresh"
        f" {args.eval_size}^2 quartets via the test_sp_fusion CLI"
        " (reference workload: sp_scripts_test/test_fusion.py:17-141)."
        " Metrics: the reference's own cv2-dialect calculate_psnr /"
        " calculate_ssim (sp_scripts_train/utils/util.py:134-186) over"
        f" sections 2 and 3; the port on {args.device}.",
        "",
        "| output | PSNR | SSIM |",
        "|---|---|---|",
    ]
    summary = {}
    for key in ROWS:
        p, s = rows[key]
        summary[key] = {"psnr": round(p, 3), "ssim": round(s, 4)}
        lines.append(f"| {key} | {p:.3f} | {s:.4f} |")
    lines.append("")
    return lines, summary


def main(argv=None):
    """Runs the tool under the "default" precision; the caller's policy is
    set back after it. Returns {row: (PSNR, SSIM)}."""
    from sstem_tpu_torch import config

    args = parser().parse_args(argv)
    prior = config.matmul_precision()
    config.set_matmul_precision("default")
    try:
        return run(args)
    finally:
        config.set_matmul_precision(prior)


def run(args):
    from PIL import Image

    from sstem_tpu_torch.cli import (
        test_sp_fusion, test_sp_interp, train_sp_correction, train_sp_fusion,
        train_sp_interp,
    )
    from sstem_tpu_torch.data.sim_sp import MaskBank

    # absolute: the stage records and the SP run's links outlive the cwd
    root = os.path.abspath(args.root)
    data = os.path.join(root, "data")
    eval_data = os.path.join(root, "eval")
    out_path = args.out or os.path.join(root, "SCORES_SP.md")
    dev = ["--device", args.device]
    k = ["--kernel-size", str(KERNEL_SIZE)]
    os.makedirs(root, exist_ok=True)

    marker = os.path.join(root, "stage.json")
    stage = {}
    if os.path.exists(marker):
        with open(marker) as f:
            stage = json.load(f)

    def done(key, value=True):
        stage[key] = value
        with open(marker, "w") as f:
            json.dump(stage, f)

    bank = MaskBank.synthetic(n=args.bank_size, seed=5)

    if "data" not in stage:
        build_quartets(data, args.quartets, args.img_size, bank, seed=11)
        done("data")
    if "eval_data" not in stage:
        build_quartets(eval_data, args.eval_quartets, args.eval_size, bank,
                       seed=77)
        done("eval_data")

    # 1) VFI (two-frame KPN; main_interp.py recipe)
    if "vfi_save" not in stage:
        paths = train_sp_interp.main(
            ["-opt", write_config(root, "sp_vfi", args, {}),
             "--max-iters", str(args.iters_vfi)] + dev)
        done("vfi_save", paths["save_path"])

    # 2) denoise U-Net (main_correction.py recipe)
    if "denoise_save" not in stage:
        paths = train_sp_correction.main(
            ["-opt", write_config(root, "sp_denoise", args, {}),
             "--max-iters", str(args.iters_denoise)] + dev)
        done("denoise_save", paths["save_path"])

    # 3) joint fusion with the pretrained branches in effect frozen (LR
    # weights 1e-20 and 1e-6, main_fusion.py:65-77). The trainer reads both
    # from one flat directory by iteration count, so the two checkpoints
    # (of distinct horizons) are linked into one.
    if "fusion_save" not in stage:
        pre = os.path.join(root, "pretrained")
        os.makedirs(pre, exist_ok=True)
        for save, iters in ((stage["vfi_save"], args.iters_vfi),
                            (stage["denoise_save"], args.iters_denoise)):
            src = os.path.join(save, "model-%06d.ckpt" % iters)
            assert os.path.exists(src), src
            dst = os.path.join(pre, "model-%06d.ckpt" % iters)
            if not os.path.exists(dst):
                os.symlink(src, dst)
        assert args.iters_vfi != args.iters_denoise, (
            "vfi/denoise horizons must differ (the shared pretrained dir "
            "keys the branches by iteration count)")
        cfg_f = write_config(root, "sp_fusion", args, {
            "if_pretrained": True, "resume_path": pre,
            "if_pretrained_vfi": True, "vfi_last_iter": args.iters_vfi,
            "if_pretrained_denoise": True,
            "denoise_last_iter": args.iters_denoise,
            "vfi_lr_weight": 1.0e-20, "denoise_lr_weight": 1.0e-6,
            "if_fusion_loss_only": False, "if_pretrained_fusion": False,
        })
        paths = train_sp_fusion.main(
            ["-opt", cfg_f, "--max-iters", str(args.iters_fusion)] + dev)
        done("fusion_save", paths["save_path"])

    # 4) restore the eval quartets through the test CLIs and score them
    def read(*parts):
        return np.asarray(Image.open(os.path.join(*parts)), np.float64)

    images = []
    for q in range(args.eval_quartets):
        stem = str(1 + q).zfill(4)
        out = os.path.join(root, "eval_out", stem)
        if not os.path.exists(os.path.join(out, "pred2.png")):
            test_sp_fusion.main([
                "-mp", stage["fusion_save"], "-dp", eval_data,
                "-im1", f"{stem}_1.png", "-im2d", f"{stem}_2_degra.png",
                "-im2m", f"{stem}_2_degra_maska.png",
                "-im3d", f"{stem}_3_degra.png",
                "-im3m", f"{stem}_3_degra_maska.png",
                "-im4", f"{stem}_4.png", "-sp", out,
            ] + dev + k)
        if not os.path.exists(os.path.join(out, "vfi_2.png")):
            test_sp_interp.main([
                "-mp", os.path.join(stage["fusion_save"], "vfi"),
                "-dp", eval_data, "-im1", f"{stem}_1.png",
                "-im2", f"{stem}_4.png", "-sp", out,
            ] + dev + k)
        for j, pred_name in ((2, "pred1.png"), (3, "pred2.png")):
            images.append((read(eval_data, f"{stem}_{j}.png"), {
                "degraded": read(eval_data, f"{stem}_{j}_degra.png"),
                "vfi": read(out, f"vfi_{j - 1}.png"),
                "fused": read(out, pred_name)}))

    rows = score_rows(images)
    lines, summary = report(args, rows)
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    print(json.dumps(summary))
    print(f"wrote {out_path}")
    return rows


if __name__ == "__main__":
    main()
