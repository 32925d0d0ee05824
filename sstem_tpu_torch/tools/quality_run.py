"""Self-trained SFF quality run (counterpart of ``tools/quality_run.py``).

Trains the full SFF chain (interp KPN K=51 -> unfolding flow -> fusion
U-Net, reference configs and losses) on synthetic CREMI-like data through
the port's CLIs, then restores a degraded synthetic stack with the fused
pipeline and reports reference-exact PSNR and SSIM for every stage output,
in float32 and in bf16 serving (the bf16 budget is a worst PSNR delta of
at least -0.1 dB).

    python -m sstem_tpu_torch.tools.quality_run [--root DIR] [--iters 1500]
        [--iters-unfold N] [--iters-fusion N] [--device-datagen]
        [--device cuda|cpu] [--out FILE]

Everything runs under ``set_matmul_precision("default")``, as the JAX tool
does: the float32 column is scored under that policy too. The bf16 column
is ``SFFPipeline(dtype=SERVING_DTYPE)`` on the fused-conv serving path
(``packed_conv``) on the card, on the cuDNN-style module path on the CPU;
the head tails stay on cuDNN (the JAX tool leaves ``fused_head_tail`` off).
Stages are resumable: ``<root>/stage.json`` records each finished one.
The tree, the configs, the checkpoints and the report (``--out``, by
default ``<root>/SCORES.md``) go under ``--root`` (by default
``build/quality_run`` in the checkout).
"""

import argparse
import glob
import json
import os

import numpy as np
import yaml

DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "quality_run")
KERNEL_SIZE = 51  # the interp KPN's K, as the JAX tool writes it
EVAL_IDS = [2, 4, 6]
OUTPUTS = ("interp", "fused", "stitch")
ROWS = ("degraded(baseline)",) + OUTPUTS

BASE_AUG = {
    "random_fliplr": True, "random_flipud": True, "random_flipz": True,
    "random_rotation": True, "swap": False, "color_jitter": False,
    "COLOR": {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2},
    "elastic_trans": False,
    "ELASTIC": {"alpha_range": 100, "sigma": 10, "shave": 20},
    "gauss_noise": False, "GAUSS": {"gauss_mean": 0, "gauss_sigma": 0.001},
}


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--iters-unfold", type=int, default=None)
    ap.add_argument("--iters-fusion", type=int, default=None)
    ap.add_argument("--device-datagen", action="store_true",
                    help="unfolding/fusion degradation inside the step")
    ap.add_argument("--triplets", type=int, default=120)
    ap.add_argument("--img-size", type=int, default=384)
    ap.add_argument("--patch", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    # unfolding and fusion at the reference recipe: base_lr 1e-4
    # (sff_flowfusionnet_L1_lr0001decay.yaml, sff_fusion_L1_lr0001decay.yaml)
    ap.add_argument("--batch-correction", type=int, default=16)
    ap.add_argument("--lr-correction", type=float, default=1e-4)
    # None: follow --lr-correction
    ap.add_argument("--lr-fusion", type=float, default=None)
    ap.add_argument("--stack-size", type=int, default=768)
    ap.add_argument("--resume", action="store_true",
                    help="continue the fusion stage from a prior *_q_fusion "
                         "dir's checkpoints (same config and flow net only; "
                         "not verified)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None,
                    help="the report (default <root>/SCORES.md)")
    return ap


def write_config(root, name, args, train_extra, data_extra):
    """The reference-style YAML of one stage, ``<root>/<name>.yaml``, as the
    JAX tool writes it; returns its path."""
    data = os.path.join(root, "data")
    cfg = {
        "NAME": name,
        "TRAIN": {
            "resume": False, "if_valid": False,
            "cache_path": os.path.join(root, "caches"),
            "save_path": os.path.join(root, "models"),
            "input_nc": 6, "output_nc": 1, "ngf": 32, "pad": 0,
            "loss": "L1", "kernel_size": KERNEL_SIZE,
            "total_iters": args.iters, "warmup_iters": 50,
            "base_lr": 1e-3, "end_lr": 1e-5,
            "display_freq": 200, "valid_freq": args.iters,
            "save_freq": args.iters,
            "decay_iters": args.iters, "weight_decay": None,
            "power": 1.5, "batch_size": args.batch, "num_workers": 2,
            "is_cuda": False, "random_seed": 7,
            **train_extra,
        },
        "DATA": {
            "folder_name": data, "train_txt": "train_data.txt",
            "patch_size": [args.patch, args.patch], "AUG": BASE_AUG,
            **data_extra,
        },
        "TEST": {"pad": 0},
    }
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def eval_stack(hw):
    """The evaluation stack: ``synth_stack(9, hw, hw, seed=99)`` with
    sections 2, 4 and 6 degraded by ``degrade_sff(det_size=hw)`` under
    ``default_rng(13)``. Returns (clean, degraded, ids, the degradations'
    dicts by id: ``flow2``, the GT unfolding flow, and ``mask``, 0 on the
    fold strip)."""
    from sstem_tpu_torch.data.sim_sff import degrade_sff
    from sstem_tpu_torch.data.synthetic import synth_stack

    clean = synth_stack(9, hw, hw, seed=99)
    rng = np.random.default_rng(13)
    degraded = clean.copy()
    gt = {}
    for i in EVAL_IDS:
        gt[i] = degrade_sff(clean[i], rng, det_size=hw)
        degraded[i] = np.asarray(gt[i]["degraded"], np.uint8)
    return clean, degraded, list(EVAL_IDS), gt


def _psnr(gt, pred):
    from sstem_tpu_torch.metrics import compute_psnr

    p = compute_psnr(gt, pred)
    return p[1] if isinstance(p, tuple) else p


def score_rows(clean, degraded, restored, ids):
    """{row: (mean PSNR, mean SSIM)} over ``ids`` of each output of
    ``restore_stack`` (``restored[i][key]``) and of the degraded sections,
    with the reference's ``compute_psnr`` / ``compute_ssim``."""
    from sstem_tpu_torch.metrics import compute_ssim

    rows = {}
    images = {key: {i: restored[i][key] for i in ids} for key in OUTPUTS}
    images["degraded(baseline)"] = {i: degraded[i] for i in ids}
    for key in ROWS:
        ps, ss = [], []
        for i in ids:
            pred = images[key][i].astype(np.float64)
            gt = clean[i].astype(np.float64)
            ps.append(_psnr(gt, pred))
            ss.append(compute_ssim(gt, pred))
        rows[key] = (float(np.mean(ps)), float(np.mean(ss)))
    return rows


def load_models(stage):
    """The three trained nets of a finished run, from its save dirs (the
    interp's K from its stage config)."""
    from sstem_tpu_torch.cli._ckpt import load_model
    from sstem_tpu_torch.compat.config import load_sff_config
    from sstem_tpu_torch.models import FusionNet, IFNet, UNetSFF

    k = load_sff_config(stage["cfg_i"]).TRAIN.kernel_size
    return (load_model(lambda: IFNet(k), stage["interp_save"]),
            load_model(lambda: FusionNet(output_nc=2, ngf=32),
                       stage["unfold_save"]),
            load_model(lambda: UNetSFF(out_channel=1), stage["fusion_save"]))


def report(args, results):
    """The report's lines (the JAX tool's table and wording) and the worst
    bf16 PSNR delta."""
    lr_fusion = (args.lr_fusion if args.lr_fusion is not None
                 else args.lr_correction)
    hw = args.stack_size
    lines = [
        "# SCORES — self-trained synthetic SFF restoration quality",
        "",
        f"Full chain trained through the real CLIs (interp {args.iters} /"
        f" unfolding {args.iters_unfold or args.iters} /"
        f" fusion {args.iters_fusion or args.iters} iters"
        f"{', device-datagen' if args.device_datagen else ''},"
        f" K={KERNEL_SIZE}, ngf=32, patch {args.patch}^2,"
        f" batch {args.batch};"
        f" unfolding at the reference recipe lr"
        f" {args.lr_correction:g}, fusion at lr {lr_fusion:g},"
        f" batch {args.batch_correction})"
        f" on {args.triplets} synthetic {args.img_size}^2 triplets;"
        f" restoration of 3 SimuSFF-degraded {hw}^2 sections of a fresh"
        " synthetic stack. Metrics: reference-exact compute_psnr /"
        " MATLAB-style compute_ssim (sstem_tpu_torch/metrics.py; semantics"
        " of sff_scripts_fusion/inference.py:174-192). The reference repo"
        " publishes no quantitative numbers (SURVEY §6) — these are the"
        " numbers its machinery would print, produced by the port"
        f" end-to-end on {args.device}.",
        "",
        "| output | f32 PSNR | f32 SSIM | bf16-packed PSNR | bf16-packed"
        " SSIM | delta dB |",
        "|---|---|---|---|---|---|",
    ]
    for key in ROWS:
        f32 = results["float32"][key]
        b16 = results["bfloat16"][key]
        lines.append(
            f"| {key} | {f32[0]:.3f} | {f32[1]:.4f} | {b16[0]:.3f} |"
            f" {b16[1]:.4f} | {b16[0] - f32[0]:+.3f} |")
    worst = min(results["bfloat16"][k][0] - results["float32"][k][0]
                for k in OUTPUTS)
    lines += [
        "",
        f"Worst bf16-serving PSNR delta: {worst:+.3f} dB"
        " (budget: >= -0.1 dB). On the card the bf16 column also runs the"
        " fused-conv serving path (models/serving.py: the conv3x3, deconv"
        " and pool kernels), so this doubles as its end-to-end quality"
        " gate.",
        "",
    ]
    return lines, worst


def main(argv=None):
    """Runs the tool under the "default" precision; the caller's policy is
    set back after it. Returns {column: score_rows}."""
    from sstem_tpu_torch import config

    args = parser().parse_args(argv)
    prior = config.matmul_precision()
    config.set_matmul_precision("default")
    try:
        return run(args)
    finally:
        config.set_matmul_precision(prior)


def run(args):
    from sstem_tpu_torch import config
    from sstem_tpu_torch.cli import (
        infer_interp_trainingset, train_fusion, train_interp,
        train_unfolding,
    )
    from sstem_tpu_torch.data.synthetic import write_triplet_tree
    from sstem_tpu_torch.infer.pipeline import SFFPipeline

    # absolute: the stage records and the SP run's links outlive the cwd
    root = os.path.abspath(args.root)
    data = os.path.join(root, "data")
    models = os.path.join(root, "models")
    out_path = args.out or os.path.join(root, "SCORES.md")
    dev = ["--device", args.device]
    os.makedirs(root, exist_ok=True)
    if not os.path.exists(os.path.join(data, "train_data.txt")):
        write_triplet_tree(data, n_triplets=args.triplets,
                           size=args.img_size, seed=7)

    marker = os.path.join(root, "stage.json")
    stage = {}
    if os.path.exists(marker):
        with open(marker) as f:
            stage = json.load(f)

    def done(key, value=True):
        stage[key] = value
        with open(marker, "w") as f:
            json.dump(stage, f)

    # 1) interp trainer
    if "interp_save" not in stage:
        cfg_i = write_config(root, "q_interp", args, {}, {})
        iargs = ["-c", cfg_i, "--max-iters", str(args.iters)] + dev
        if args.device_datagen:
            iargs.append("--device-datagen")
        done("interp_save", train_interp.main(iargs)["save_path"])
        done("cfg_i", cfg_i)
    cfg_i = stage["cfg_i"]

    # 2) interp over the training set
    if not stage.get("interp_ts"):
        infer_interp_trainingset.main(
            ["-c", cfg_i, "--ckpt", stage["interp_save"], "-bs", "4"] + dev)
        done("interp_ts")

    correction_data = {
        "patch_size": [args.img_size, args.img_size],
        "det_size": args.patch,
        "interp_train_txt": "interp_train_data.txt",
        "gt_line": False,
    }
    # 3) unfolding trainer (on-the-fly degradation)
    if "unfold_save" not in stage:
        it_u = args.iters_unfold or args.iters
        cfg_u = write_config(
            root, "q_unfold", args,
            {"output_nc": 2, "total_iters": it_u, "decay_iters": it_u,
             "valid_freq": it_u, "save_freq": min(8000, it_u),
             "base_lr": args.lr_correction,
             "batch_size": args.batch_correction},
            correction_data)
        uargs = ["-c", cfg_u, "--max-iters", str(it_u)] + dev
        if args.device_datagen:
            uargs.append("--device-datagen")
        done("unfold_save", train_unfolding.main(uargs)["save_path"])

    # 4) fusion trainer behind the frozen flow net
    if "fusion_save" not in stage:
        flow_ckpts = glob.glob(
            os.path.join(stage["unfold_save"], "model-*.ckpt"))
        it_f = args.iters_fusion or args.iters
        cfg_f = write_config(
            root, "q_fusion", args,
            {"output_nc": 1, "total_iters": it_f, "decay_iters": it_f,
             # periodic saves: an interrupted long horizon still leaves an
             # evaluable checkpoint at the last 4k boundary
             "valid_freq": it_f, "save_freq": min(4000, it_f),
             "base_lr": (args.lr_fusion if args.lr_fusion is not None
                         else args.lr_correction),
             "batch_size": args.batch_correction,
             "flownet_path": stage["unfold_save"],
             "flownet_id": os.path.basename(sorted(flow_ckpts)[-1])},
            correction_data)
        fargs = ["-c", cfg_f, "--max-iters", str(it_f)] + dev
        if args.device_datagen:
            fargs.append("--device-datagen")
        # --resume opts in to continuing an interrupted fusion stage from
        # the newest prior save dir; off by default, since resuming across
        # a config change or a retrained flow net would taint the scores
        if args.resume:
            prior = [d for d in sorted(glob.glob(
                os.path.join(models, "*_q_fusion")))
                if glob.glob(os.path.join(d, "model-*.ckpt"))]
            if prior:
                fargs += ["--resume-from", prior[-1]]
                print(f"resuming fusion stage from {prior[-1]}", flush=True)
        done("fusion_save", train_fusion.main(fargs)["save_path"])

    # 5) degrade a fresh synthetic stack and restore it, f32 and bf16
    clean, degraded, ids, _ = eval_stack(args.stack_size)
    results = {}
    for mode, dtype in (("float32", config.PARITY_DTYPE),
                        ("bfloat16", config.SERVING_DTYPE)):
        pipe = SFFPipeline(*load_models(stage), device=args.device,
                           dtype=dtype,
                           packed_conv=(mode == "bfloat16"
                                        and args.device == "cuda"))
        res = pipe.restore_stack(degraded, ids, chunk=len(ids))
        results[mode] = score_rows(clean, degraded, res, ids)
        print(mode, results[mode], flush=True)

    lines, worst = report(args, results)
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out_path}; worst bf16 delta {worst:+.3f} dB", flush=True)
    return results


if __name__ == "__main__":
    main()
