"""SP (stain-precipitate) degradation synthesis — host-side mask machinery
(counterpart of ``sstem_tpu/data/sim_sp.py``, copied: numpy, cv2 and scipy).

Re-implements the reference simulator semantics (simu_sp/) on cv2 + numpy.
This stage is contour-based (cv2 moments/contours/resize), so it runs on the
host in both packages and writes the degraded frames and masks that the SP
datasets read. The same seed gives the same bank, frames and masks as the
JAX package.

Components and their reference counterparts:
  * ``bca_adjust`` — global brightness/contrast shift with
    ``alpha ~ U(0.3, 0.5), beta = 170 - 147 alpha`` (simu_sp.py:34-36,158-160)
  * ``place_mask`` — rejection placement of one mask triple with the
    3-mask blend ``out = out*mask10 + out*mask01*(grad/255)``
    (multiply_mask, simu_sp.py:39-154). The reference's big-mask corner test
    mixes (x,y)/(y,x) coordinate orders (simu_sp.py:21-24); we implement the
    intended check — all four rect corners >= 250 px from existing blobs —
    via a distance transform.
  * ``simu_sp`` — stratified mask sampling (1000 draws, 5 area bins with
    quotas [10,8,5,3,1], '<=' comparison kept so effective quotas are one
    higher), sorted largest-first, paste loop, and the two derived masks:
    maska = grad-mask + inverse-contour, maskb re-extracted from the degraded
    image (simu_sp.py:157-264). The reference reads the bank from a *global*
    ``mask_root`` instead of its parameter (simu_sp.py:181,232) — fixed here.
  * ``extract_m`` — artifact mask recovery: border-pad 100, threshold 127,
    keep regions with mean masked intensity <= 220/3, MORPH_CLOSE ellipse(70)
    (extractM.py:7-60)
  * ``mask01_grad_mask`` — per-contour radial alpha profile: 50 concentric
    centroid-anchored scaled rings, ring values from the DisValue cubic,
    scaled center fill (extractM.py:63-140)
  * ``average_alpha`` / ``dis_value`` — the area/scale cubics
    (fill_contours.py:34-65)
  * ``scaled_fill`` / ``scaled_ring`` / ``scaled_center`` — centroid-anchored
    contour rescaling (scaled_contour.py:6-224)
  * ``MaskBank`` — mask/mask10/mask01 triples; ``from_dirs`` loads the
    published bank, ``build_from_binary`` builds triples from raw blob masks
    (fill_contours.SaveMask01 + Fill_alphaMap equivalents), ``synthetic``
    generates a test bank from random blobs.
"""

import os
from dataclasses import dataclass, field

import cv2
import numpy as np

from sstem_tpu_torch.data.synthetic import synth_blob_mask


def bca_adjust(img, alpha, beta):
    return img.astype(np.float64) * alpha + beta


def _largest_contour(gray, thresh=127):
    _, binary = cv2.threshold(gray, thresh, 255, cv2.THRESH_BINARY)
    contours, _ = cv2.findContours(binary, cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)
    if not contours:
        return None, 0.0, []
    areas = [cv2.contourArea(c) for c in contours]
    i = int(np.argmax(areas))
    return contours[i], areas[i], contours


def _centroid(contour):
    m = cv2.moments(contour)
    if m["m00"] != 0:
        return int(m["m10"] / m["m00"]), int(m["m01"] / m["m00"])
    return int((m["m10"] + 0.01) / (m["m00"] + 0.01)), int(
        (m["m01"] + 0.01) / (m["m00"] + 0.01)
    )


def scaled_fill(mask, scale, thresh=127):
    """Centroid-anchored scaled fill of the largest contour; zeros if the
    scaled patch would not fit (reference shape-check behavior)."""
    contour, _, _ = _largest_contour(mask, thresh)
    if contour is None:
        return np.zeros_like(mask)
    filled = np.zeros_like(mask)
    cv2.fillPoly(filled, [contour], 255)
    cx, cy = _centroid(contour)
    scaled = cv2.resize(filled, None, fx=scale, fy=scale,
                        interpolation=cv2.INTER_CUBIC)
    h, w = scaled.shape[:2]
    y0, x0 = cy - int(cy * scale), cx - int(cx * scale)
    out = np.zeros_like(mask)
    if 0 <= y0 and 0 <= x0 and y0 + h <= out.shape[0] and x0 + w <= out.shape[1]:
        out[y0:y0 + h, x0:x0 + w] = scaled
        return out
    if out[max(y0, 0):y0 + h, max(x0, 0):x0 + w].shape != scaled.shape:
        return np.zeros_like(mask)
    out[y0:y0 + h, x0:x0 + w] = scaled
    return out


def scaled_ring(mask, scale1, scale2):
    """Ring between two centroid-anchored scales (multiscale_simplify)."""
    outer = scaled_fill(mask, scale1).astype(np.float64) / 255.0
    inner = scaled_fill(mask, scale2).astype(np.float64) / 255.0
    return outer * (1.0 - inner) * 255.0


def scaled_center(mask, scale):
    """Scaled center fill (scaled_contour.py:6-41, threshold 40)."""
    return scaled_fill(mask, scale, thresh=40)


def _outlined_scaled_patch(filled, scale, value):
    """Resize the filled blob, re-extract its contours from the 127-threshold
    binary, and draw their outlines back at ``value`` (the drawContours step
    of scaled_contour.py:116-124)."""
    scaled = cv2.resize(filled, None, fx=scale, fy=scale,
                        interpolation=cv2.INTER_CUBIC)
    _, binary = cv2.threshold(scaled, 127, 255, cv2.THRESH_BINARY)
    contours, _ = cv2.findContours(binary, cv2.RETR_TREE,
                                   cv2.CHAIN_APPROX_NONE)
    cv2.drawContours(scaled, contours, -1, value)
    return scaled


def _centroid_anchored(base, patch, cx, cy, scale):
    """Place ``patch`` so the scaled centroid lands on the original one;
    ``None`` when the reference's shape check fails (scaled_contour.py:131)."""
    out = np.zeros_like(base)
    h, w = patch.shape[:2]
    y0, x0 = cy - int(cy * scale), cx - int(cx * scale)
    if out[max(y0, 0):y0 + h, max(x0, 0):x0 + w].shape != patch.shape:
        return None
    out[y0:y0 + h, x0:x0 + w] = patch
    return out


def _ring_outlined(mask, scale1, scale2, value, out_dtype):
    """Shared body of the two outline-drawing multiscale ring variants
    (scaled_contour.py:90-163 / :227-293). Reference quirks preserved:

    * the initial contours come from the UNthresholded gray image (the
      127-threshold binary is computed and then unused, :96-97);
    * on a placement-shape mismatch the result is a zeros array of the
      *scaled-patch* shape, not the input shape (:159-163);
    * ``refine`` fills the largest contour with 0 on a zeros canvas, so its
      filled blob (and therefore its output) is identically zero — the
      function is faithfully dead (:242).
    """
    contours, _ = cv2.findContours(mask, cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)
    if not contours:
        return np.zeros_like(mask)
    areas = [cv2.contourArea(c) for c in contours]
    largest = contours[int(np.argmax(areas))]
    filled = np.zeros_like(mask)
    cv2.fillPoly(filled, [largest], value)
    cx, cy = _centroid(largest)

    # failure paths return raw zeros of the scaled-patch shape in the MASK's
    # dtype (no float cast — reference :159-163)
    patch1 = _outlined_scaled_patch(filled, scale1, value)
    outer = _centroid_anchored(mask, patch1, cx, cy, scale1)
    if outer is None:
        return np.zeros_like(patch1)
    patch2 = _outlined_scaled_patch(filled, scale2, value)
    inner = _centroid_anchored(mask, patch2, cx, cy, scale2)
    if inner is None:
        return np.zeros_like(patch2)
    ring = (outer / 255.0) * ((255.0 - inner) / 255.0) * 255.0
    return ring.astype(out_dtype)


def scaled_ring_outlined(mask, scale1, scale2):
    """scaled_contour_multiscale (scaled_contour.py:90-163): like
    ``scaled_ring`` but each scaled patch gets its re-extracted contour
    outlines drawn back at 255 before compositing; returns float64."""
    return _ring_outlined(mask, scale1, scale2, 255, np.float64)


def refine_ring_outlined(mask, scale1, scale2):
    """refine_contour_multiscale (scaled_contour.py:227-293): the inverted
    variant that fills and outlines with 0 — identically zero for any input
    by construction (see _ring_outlined quirk notes); returns uint8."""
    return _ring_outlined(mask, scale1, scale2, 0, np.uint8)


def area_scales(area):
    """Ring-count schedule by blob area (fill_contours.AreaScales_unified,
    fill_contours.py:19-30): bigger blobs get more concentric rings."""
    if area <= 5000:
        n = 20
    elif area <= 15000:
        n = 25
    elif area <= 30000:
        n = 35
    elif area <= 80000:
        n = 50
    else:
        n = 70
    return np.linspace(1.0, 0.05, n)


def opening(mask):
    """3x3 morphological opening (fill_contours.Opening)."""
    k = np.ones((3, 3), np.uint8)
    return cv2.morphologyEx(mask.astype(np.float64), cv2.MORPH_OPEN,
                            kernel=k, iterations=1).astype(np.uint8)


def dis_trans_alpha(mask):
    """10-iteration binary erosion to uint8 (fill_contours.DisTransAlpha)."""
    from scipy.ndimage import binary_erosion

    out = binary_erosion(mask, iterations=10, border_value=1)
    return (out * 255).astype(np.uint8)


def average_alpha(area):
    """Cubic fit of mean artifact intensity vs area (fill_contours.py:34-41)."""
    return (-9.662e-17 * area**3 + 4.709e-11 * area**2
            - 7.72e-6 * area + 0.7038)


def dis_value(scale, area, average_intensity):
    """3-regime cubic radial intensity profile (fill_contours.py:44-65)."""
    if area <= 10000:
        p = (0.04202, 0.5332, -0.02127, 0.7099)
    elif area <= 60000:
        p = (0.7586, 0.2427, 0.2224, 0.386)
    else:
        p = (2.104, -0.4489, 0.4921, -0.02028)
    s = np.asarray(scale, dtype=np.float64)
    return (p[0] * s**3 + p[1] * s**2 + p[2] * s + p[3]) * average_intensity


def radial_alpha_map(mask10, area=None, n_rings=50):
    """Fill the largest contour of a binary mask with the radial profile:
    50 concentric rings + center (the shared core of Mask01_GradMask and
    Fill_alphaMap)."""
    contour, carea, _ = _largest_contour(mask10)
    if contour is None:
        return np.zeros_like(mask10, dtype=np.float64)
    if area is None:
        area = carea
    area = min(area, 300000)
    scales = np.linspace(1.0, 0.05, n_rings)
    values = dis_value(scales, area, average_alpha(area))
    mx = values.max()
    if mx > 0:
        values = values / mx
    blank = np.zeros_like(mask10, dtype=np.float64)
    for ss in range(len(scales) - 1):
        ring = scaled_ring(mask10, scales[ss], scales[ss + 1]) / 255.0
        if ring.max() > 0:
            blank += ring * values[ss]
    center = scaled_center(mask10, scales[-1]).astype(np.float64)
    vvv = values[-1] if values[-1] != 0 else values[-2]
    blank += center / 255.0 * vvv
    return blank


def extract_m(img, if_select_masks=True):
    """Recover the artifact mask from a degraded image (extractM.ExtractM)."""
    if img.ndim == 3:
        img = img[:, :, 0]
    padded = np.zeros((img.shape[0] + 200, img.shape[1] + 200), np.uint8)
    padded[:] = 255
    padded[100:-100, 100:-100] = img

    _, binary = cv2.threshold(padded, 127, 255, cv2.THRESH_BINARY)
    contours, _ = cv2.findContours(binary, cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)
    areas = [cv2.contourArea(c) for c in contours]
    order = np.argsort(areas)

    van2 = np.ones_like(padded, np.uint8) * 255
    thickness = 10 if if_select_masks else 40
    # all but the largest region (the border frame)
    for idx in order[:-1] if len(order) else []:
        a = areas[idx]
        if a <= 50:
            continue
        c = contours[idx]
        if if_select_masks:
            tmp = np.zeros_like(padded, np.uint8)
            x, y, w, h = cv2.boundingRect(c)
            cv2.drawContours(tmp, contours, int(idx), 255, 0)
            cv2.fillPoly(tmp, [c], 255)
            sub_mask = tmp[y:y + h, x:x + w].astype(np.float64) / 255.0
            sub_img = padded[y:y + h, x:x + w].astype(np.float64)
            if (sub_mask * sub_img).sum() / a > 220 / 3:
                continue
        cv2.drawContours(van2, contours, int(idx), 0, thickness)
        cv2.fillPoly(van2, [c], 0)

    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (70, 70))
    van2 = cv2.morphologyEx(van2, cv2.MORPH_CLOSE, kernel)
    van = (255 - van2).astype(np.uint8)
    return van[100:-100, 100:-100]


def mask01_grad_mask(mask10map):
    """Radial alpha profile for every large region of a recovered mask
    (extractM.Mask01_GradMask): output is the grad map inside regions and
    255 outside."""
    if mask10map.ndim == 3:
        mask10map = mask10map[:, :, 0]
    h, w = mask10map.shape
    padded = np.zeros((h + 100, w + 100), np.uint8)
    padded[50:-50, 50:-50] = mask10map
    _, binary = cv2.threshold(padded, 127, 255, cv2.THRESH_BINARY)
    contours, _ = cv2.findContours(binary, cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)
    areas = [cv2.contourArea(c) for c in contours]

    grad = padded.copy()
    for ci, a in enumerate(areas):
        if a <= 200:
            continue
        cv2.fillPoly(padded, [contours[ci]], 255)
        cv2.drawContours(padded, contours, ci, 255, thickness=1)
        x, y, ww, hh = cv2.boundingRect(contours[ci])
        sub = padded[y:y + hh, x:x + ww]
        blank = radial_alpha_map(sub, area=min(a, 300000))
        grad[y:y + hh, x:x + ww] = np.clip(blank * 255.0, 0, 255)

    mask01_inv = 255.0 - padded.astype(np.float64)
    out = np.clip(grad.astype(np.float64) + mask01_inv, 0, 255).astype(np.uint8)
    return out[50:-50, 50:-50]


@dataclass
class MaskBank:
    """mask (grad alpha, uint8) / mask10 (keep-background 0/1 float) /
    mask01 (mask-region 0/1 float) triples + largest-contour areas."""

    masks: list = field(default_factory=list)
    mask10s: list = field(default_factory=list)
    mask01s: list = field(default_factory=list)
    areas: list = field(default_factory=list)

    def __len__(self):
        return len(self.masks)

    @staticmethod
    def from_dirs(mask_root, mask10_root, mask01_root):
        """Load the published bank layout (README.md:111)."""
        from PIL import Image

        bank = MaskBank()
        for name in sorted(os.listdir(mask_root)):
            if name == "mask0.png" or not name.endswith(".png"):
                continue
            m = np.asarray(Image.open(os.path.join(mask_root, name)))
            if m.ndim == 3:
                m = m[:, :, 0]
            m10 = np.asarray(Image.open(os.path.join(mask10_root, name)))
            m01 = np.asarray(Image.open(os.path.join(mask01_root, name)))
            if m10.ndim == 3:
                m10 = m10[:, :, 0]
            if m01.ndim == 3:
                m01 = m01[:, :, 0]
            _, area, _ = _largest_contour(m, thresh=20)
            bank.masks.append(m)
            bank.mask10s.append(m10.astype(np.float64) / 255.0)
            bank.mask01s.append(m01.astype(np.float64) / 255.0)
            bank.areas.append(area)
        return bank

    @staticmethod
    def build_from_binary(blob_masks):
        """Build triples from raw binary blob masks (SaveMask01 +
        Fill_alphaMap equivalents)."""
        bank = MaskBank()
        for blob in blob_masks:
            contour, area, _ = _largest_contour(blob, thresh=20)
            if contour is None or area < 300:
                continue
            mask01 = np.zeros_like(blob)
            cv2.fillPoly(mask01, [contour], 255)
            mask10 = 255 - mask01
            n_rings = len(area_scales(area))  # Fill_alphaMap ring schedule
            grad = np.clip(
                radial_alpha_map(mask01, area, n_rings=n_rings) * 255.0,
                0, 255)
            bank.masks.append(grad.astype(np.uint8))
            bank.mask10s.append(mask10.astype(np.float64) / 255.0)
            bank.mask01s.append(mask01.astype(np.float64) / 255.0)
            bank.areas.append(area)
        return bank

    @staticmethod
    def synthetic(n=24, seed=0, size_range=(96, 320)):
        """Random-blob bank for tests/benchmarks (no external download)."""
        rng = np.random.default_rng(seed)
        blobs = []
        for i in range(n):
            s = int(rng.integers(*size_range))
            r = (max(12, s // 8), max(16, s // 3))
            blobs.append(synth_blob_mask(s, s, seed=seed * 1000 + i,
                                         rmin=r[0], rmax=r[1]))
        return MaskBank.build_from_binary(blobs)


def place_mask(out_img, mask, mask10, mask01, state, rng, if_big, area,
               max_tries=200):
    """Place one mask triple at a random non-overlapping location and blend.

    state: dict with 'map' (occupied boxes), 'contour' (mask01 union),
    'grad' (grad union), 'big' (mask01 union of area>60000 masks).
    Returns True if placed."""
    h, w = out_img.shape[:2]
    hm, wm = mask.shape[:2]
    mask_f = mask.astype(np.float64) / 255.0

    dist = None
    if if_big:
        occupied = (state["map"] > 127).astype(np.uint8)
        # distance from each pixel to the nearest occupied pixel
        dist = cv2.distanceTransform(1 - occupied, cv2.DIST_L2, 3)

    for _ in range(max_tries):
        y0 = int(rng.integers(0, h))
        x0 = int(rng.integers(0, w))
        y1 = min(y0 + hm, h)
        x1 = min(x0 + wm, w)
        ch, cw = y1 - y0, x1 - x0

        # rejection: the rect must not intersect any occupied box
        if state["map"][y0:y1, x0:x1].sum() != 0:
            continue
        if if_big:
            corners = [(y0, x0), (y0, x1 - 1), (y1 - 1, x0), (y1 - 1, x1 - 1)]
            if any(dist[cy, cx] < 250 for cy, cx in corners):
                continue

        m10 = mask10[:ch, :cw]
        m01 = mask01[:ch, :cw]
        mg = mask_f[:ch, :cw]
        region = out_img[y0:y1, x0:x1]
        out_img[y0:y1, x0:x1] = region * m10 + region * m01 * mg

        state["map"][y0:y1, x0:x1] = 255
        state["contour"][y0:y1, x0:x1] = m01
        state["grad"][y0:y1, x0:x1] = mask[:ch, :cw]
        if area > 60000:
            state["big"][y0:y1, x0:x1] = m01
        return True
    return False


def simu_sp(img, bank: MaskBank, rng, num_draws=1000,
            area_stat=(5000, 15000, 30000, 80000),
            area_nums_stat=(10, 8, 5, 3, 1)):
    """Degrade one section with stain-precipitate blobs.

    Returns (degraded uint8, maska uint8, maskb uint8) — maska is the
    grad-mask union + inverse contour map, maskb is re-extracted from the
    degraded image via extract_m + mask01_grad_mask (simu_sp.py:254-264).
    """
    if img.ndim == 3:
        img = img[:, :, 0]
    alpha = rng.uniform(0.3, 0.5)
    beta = 170 - 147 * alpha
    out_img = bca_adjust(img, alpha, beta)
    h, w = out_img.shape

    # stratified sampling into area bins
    quota = list(area_nums_stat)
    count = [0] * 5
    chosen = []  # (area, idx)
    bins = np.asarray(area_stat, dtype=np.float64)
    for _ in range(num_draws + 1):
        idx = int(rng.integers(0, len(bank)))
        a = bank.areas[idx]
        b = int(np.searchsorted(bins, a, side="right"))
        if count[b] <= quota[b]:  # reference '<=' kept (quota+1 effective)
            chosen.append((a, idx))
            count[b] += 1

    chosen.sort(key=lambda t: t[0], reverse=True)

    state = {
        "map": np.zeros((h, w), np.float64),
        "contour": np.zeros((h, w), np.float64),
        "grad": np.zeros((h, w), np.float64),
        "big": np.zeros((h, w), np.float64),
    }
    for a, idx in chosen:
        place_mask(out_img, bank.masks[idx], bank.mask10s[idx],
                   bank.mask01s[idx], state, rng, if_big=a > 80000, area=a)

    degra = np.clip(out_img, 0, 255).astype(np.uint8)
    grad_union = state["grad"].astype(np.uint8)
    contour_r = 255.0 - state["contour"] * 255.0
    maska = np.clip(grad_union + contour_r, 0, 255).astype(np.uint8)
    maskb = mask01_grad_mask(extract_m(degra))
    return degra, maska, maskb
