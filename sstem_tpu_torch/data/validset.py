"""Validation-set builder for the unfolding/fusion stages (counterpart of
``sstem_tpu/data/validset.py``, on the port's ``degrade_sff``).

The reference consumes precomputed valid sets: degraded sections + interp
images + ground-truth unfolding flow stored in ``<name>_flow.hdf`` HDF5
sidecars under key 'flow2' (sff_scripts_unfolding/provider_valid.py:27-54),
but ships no builder for them. This generates such a set from clean
sections + interp images with the same degradation model as training.
``unfolding_valid_items`` yields the same items without writing them (and
without h5py, which the HDF5 sidecars need).
"""

import os

import numpy as np

from sstem_tpu_torch.data.sim_sff import degrade_sff


def unfolding_valid_items(folder, rows, interp_names=None, crop=400,
                          det=256, seed=0, line_width_range=(5, 50)):
    """The valid set's items, one per row, in the order and with the draws
    of ``make_unfolding_validset``: dicts of ``degraded``, ``interp`` and
    ``gt`` (det^2 uint8, the centre crop) and ``flow2`` (det^2 x 2
    float32). Needs no h5py."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i, row in enumerate(rows):
        clean = np.asarray(Image.open(os.path.join(folder, row[1])))
        if interp_names is not None:
            interp = np.asarray(
                Image.open(os.path.join(folder, interp_names[i]))
            )
        else:
            interp = clean
        h, w = clean.shape
        ci = (h - crop) // 2
        cj = (w - crop) // 2
        crop_img = clean[ci:ci + crop, cj:cj + crop]
        interp_c = interp[ci:ci + crop, cj:cj + crop]
        off = (crop - det) // 2

        d = degrade_sff(crop_img, rng, det_size=det,
                        line_width_range=line_width_range)
        yield dict(degraded=d["degraded"],
                   interp=interp_c[off:-off, off:-off] if off else interp_c,
                   gt=crop_img[off:-off, off:-off] if off else crop_img,
                   flow2=d["flow2"])


def make_unfolding_validset(folder, out_dir, rows, interp_names=None,
                            crop=400, det=256, seed=0,
                            line_width_range=(5, 50)):
    """Build a valid set; returns the list of txt rows written.

    rows: triplet rows (only the middle/clean column is used).
    interp_names: per-row interp image names (defaults to the clean section
    itself — a stand-in when no interp stage output exists).
    Writes per item (``unfolding_valid_items``): NNNN.png (degraded),
    NNNN_interp.png, NNNN_gt.png, NNNN_flow.hdf ('flow2'), plus valid txt
    files for both the unfolding dialect (deg interp flow.hdf) and the
    fusion dialect (deg interp gt).
    """
    import h5py
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    unfold_rows, fusion_rows = [], []
    items = unfolding_valid_items(folder, rows, interp_names, crop, det, seed,
                                  line_width_range)
    for i, item in enumerate(items):
        stem = "%04d" % i
        for suffix, key in ((".png", "degraded"), ("_interp.png", "interp"),
                            ("_gt.png", "gt")):
            Image.fromarray(item[key]).save(os.path.join(out_dir, stem + suffix))
        with h5py.File(os.path.join(out_dir, stem + "_flow.hdf"), "w") as f:
            f.create_dataset("flow2", data=item["flow2"])
        unfold_rows.append(
            f"{stem}.png {stem}_interp.png {stem}_flow.hdf")
        fusion_rows.append(f"{stem}.png {stem}_interp.png {stem}_gt.png")

    with open(os.path.join(out_dir, "unfolding_valid.txt"), "w") as f:
        f.write("\n".join(unfold_rows) + "\n")
    with open(os.path.join(out_dir, "fusion_valid.txt"), "w") as f:
        f.write("\n".join(fusion_rows) + "\n")
    return unfold_rows
