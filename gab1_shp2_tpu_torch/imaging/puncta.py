"""PLA puncta quantification (torch).

Counterpart of ``gab1_shp2_tpu/imaging/puncta.py``.  The reference ships
three declarative CellProfiler v5 pipelines (``CellProfiler/*.cppipe``)
that quantify proximity-ligation-assay (PLA) puncta per cell — the
experimental data behind the priors and the 26.4% SHP2-bound-GAB1 fit
datum.  Their computational core is: background correction (top-hat),
speckle enhancement at a ~10 px feature scale
(``GAB1-SHP2_PLA_quantification_40x+_max-zproj.cppipe`` module 43),
primary-object identification by thresholding + local maxima, and
per-cell counting.

Images are stacked as (..., H, W) float32 tensors; a whole imaging plate
is one call, computed where the tensors lie.  The entry points
(:func:`count_puncta`, :func:`identify_cells`,
:func:`count_puncta_per_cell`) take ``device=None``, which means the
CUDA card and raises without one.

Where the JAX package's numbers depend on the order of a floating-point
reduction, this module fixes it, so that the card and the CPU give the
same masks, counts and labels:

* the Gaussian filter is a sum of shifted, scaled copies, one tap at a
  time (a multiply and an add, each rounded on its own), not a
  convolution library call whose summation order depends on the device;
* the threshold statistics (Otsu's class means, Li's iteration)
  accumulate in float64 from the float32 image.

Grayscale morphology is ``max_pool2d`` (and ``-max_pool2d(-x)`` for
erosion): its implicit -inf padding gives the edge-replicated window's
max or min, because every window holds the pixel it is centred on, and
a window that reaches past the border holds the border pixel.  Labels
pass through the pooling as float32, exact up to 2**24.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gab1_shp2_tpu_torch.models.params import resolve_device

# labels go through max_pool2d (floating point only) as float32, which
# holds every integer up to 2**24 exactly
MAX_LABEL = 1 << 24
# dilations between two checks of _propagate_labels' fixpoint (each
# check is one host sync)
FIXPOINT_CHECK_EVERY = 16


def _gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    w = torch.exp(-0.5 * (x / sigma) ** 2)
    return w / w.sum()


def _taps(x: torch.Tensor, weights, dim: int, n: int) -> torch.Tensor:
    """``sum_i weights[i] * x.narrow(dim, i, n)``, tap by tap."""
    out = x.narrow(dim, 0, n) * weights[0]
    for i in range(1, len(weights)):
        out = out + x.narrow(dim, i, n) * weights[i]
    return out


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian filter on (..., H, W), edges replicated."""
    radius = max(1, int(3 * sigma + 0.5))
    # the weights are float32 numbers, computed on the CPU for every
    # device, so each tap multiplies by the same value everywhere
    w = _gaussian_kernel1d(sigma, radius).tolist()
    shape = img.shape
    H, W = shape[-2:]
    x = img.reshape((-1, 1) + tuple(shape[-2:]))
    x = F.pad(x, (radius, radius, radius, radius), mode="replicate")
    x = _taps(x, w, -1, W)                  # blur along W
    x = _taps(x, w, -2, H)                  # blur along H
    return x.reshape(shape)


def _morph(img: torch.Tensor, size: int, op: str) -> torch.Tensor:
    """Grayscale dilation (``op="max"``) or erosion (``"min"``) with a
    (size x size) square element, edges replicated (the window of pixel
    i spans i - size//2 .. i - size//2 + size - 1, as in the JAX
    package)."""
    shape = img.shape
    H, W = shape[-2:]
    x = img.reshape((-1, 1) + tuple(shape[-2:]))
    if op == "min":
        x = -x
    out = F.max_pool2d(x, size, stride=1, padding=size // 2)
    out = out[..., :H, :W]                  # an even size gives H+1 rows
    if op == "min":
        out = -out
    return out.reshape(shape)


def white_tophat(img: torch.Tensor, size: int = 11) -> torch.Tensor:
    """img - opening(img): removes background larger than the element
    (the pipelines' TopHatTransform before speckle enhancement)."""
    opened = _morph(_morph(img, size, "min"), size, "max")
    return img - opened


def enhance_speckles(img: torch.Tensor, feature_size: float = 10.0
                     ) -> torch.Tensor:
    """Difference-of-Gaussians band-pass at the puncta scale
    (EnhanceOrSuppressFeatures 'Speckles', feature size 10 px)."""
    lo = gaussian_blur(img, feature_size / 6.0)
    bg = gaussian_blur(img, feature_size)
    return torch.clamp(lo - bg, min=0.0)


def _normalized(img: torch.Tensor):
    """(img - min) / max(max - min, 1e-12) in float32 over the trailing
    (H, W) axes, flattened, with the per-image min and max."""
    lo = img.amin(dim=(-2, -1), keepdim=True)
    hi = img.amax(dim=(-2, -1), keepdim=True)
    norm = (img - lo) / torch.clamp(hi - lo, min=1e-12)
    return norm.reshape(norm.shape[:-2] + (-1,)), lo[..., 0, 0], hi[..., 0, 0]


def otsu_threshold(img: torch.Tensor, nbins: int = 64) -> torch.Tensor:
    """Otsu's threshold over the trailing (H, W) axes (float64, as the
    JAX package returns it with 64-bit mode on)."""
    flat, lo, hi = _normalized(img.to(torch.float32))
    n = flat.shape[-1]
    f64 = flat.double()
    edges = torch.linspace(0.0, 1.0, nbins + 1, dtype=torch.float64,
                           device=img.device)[1:-1]
    scores = []
    for t in edges:
        below = f64 <= t
        w1 = below.sum(-1, dtype=torch.float64) / n
        w2 = 1.0 - w1
        s1 = torch.where(below, f64, 0.0).sum(-1)
        s2 = torch.where(below, 0.0, f64).sum(-1)
        m1 = torch.where(w1 > 0, s1 / torch.clamp(w1 * n, min=1e-12), 0.0)
        m2 = torch.where(w2 > 0, s2 / torch.clamp(w2 * n, min=1e-12), 0.0)
        scores.append(w1 * w2 * (m1 - m2) ** 2)
    best = edges[torch.argmax(torch.stack(scores), dim=0)]
    return lo.double() + best * (hi.double() - lo.double())


def li_threshold(img: torch.Tensor, *, correction: float = 1.0,
                 bounds=(0.0, 1.0), smoothing_scale: float = 0.0,
                 n_iter: int = 50) -> torch.Tensor:
    """Minimum cross-entropy (Li) threshold over trailing (H, W) axes.

    CellProfiler's default "Minimum Cross-Entropy" thresholding method
    (all three shipped pipelines use it for cells and puncta, e.g.
    ``GAB1-SHP2_PLA_quantification_40x+_max-zproj.cppipe`` module 14:
    correction 1.08; module 57 PLA puncta: correction 0.2, bounds
    (0.2, 1.0)).  Li's fixed-point iteration
    ``t <- (m_bg - m_fg) / (log m_bg - log m_fg)`` on the [0, 1]
    normalized intensities, ``n_iter`` times; ``correction`` multiplies
    and ``bounds`` clip the normalized threshold exactly as
    CellProfiler's "Threshold correction factor" / "Lower and upper
    bounds" do.  ``smoothing_scale`` is CellProfiler's pre-threshold
    Gaussian (sigma = scale / 2.35, its FWHM convention).  Returns
    float32, as the JAX package does; the iteration runs in float64."""
    img = img.to(torch.float32)
    if smoothing_scale > 0:
        img = gaussian_blur(img, smoothing_scale / 2.35)
    norm, lo, hi = _normalized(img)
    flat = (norm + 1e-4).double()             # Li needs > 0
    n = flat.shape[-1]
    t = flat.mean(-1)
    for _ in range(n_iter):
        below = flat <= t[..., None]
        nb = below.sum(-1, dtype=torch.float64)
        nf = n - nb
        mb = torch.where(below, flat, 0.0).sum(-1) / torch.clamp(nb, min=1.0)
        mf = torch.where(below, 0.0, flat).sum(-1) / torch.clamp(nf, min=1.0)
        mb = torch.clamp(mb, min=1e-6)
        mf = torch.clamp(mf, min=1e-6)
        t_new = (mb - mf) / (torch.log(mb) - torch.log(mf))
        # degenerate split (all pixels one side): keep the current t
        t = torch.where((nb > 0) & (nf > 0), t_new, t)
    t = torch.clamp(t * correction, bounds[0], bounds[1])
    return (lo.double() + t * (hi.double() - lo.double())).to(torch.float32)


class PunctaResult(NamedTuple):
    count: torch.Tensor      # (...,) number of detected puncta
    mask: torch.Tensor       # (..., H, W) detected maxima
    enhanced: torch.Tensor   # (..., H, W) speckle-enhanced image


def count_puncta(img, *, feature_size: float = 10.0,
                 tophat_size: int = 11, min_distance: int = 3,
                 threshold=None, threshold_method: str = "otsu",
                 threshold_correction: float = 1.0,
                 threshold_bounds=(0.0, 1.0), device=None) -> PunctaResult:
    """Count PLA puncta in (..., H, W) images.

    Pipeline: white top-hat -> speckle DoG -> threshold ->
    local-maximum detection within ``min_distance`` -> count.

    ``threshold_method="li"`` with ``threshold_correction=0.2`` and
    ``threshold_bounds=(0.2, 1.0)`` reproduces the shipped PLA-puncta
    identification settings (``GAB1-SHP2_PLA_quantification_40x+_
    max-zproj.cppipe`` module 57: Minimum Cross-Entropy, correction
    0.2, lower bound 0.2, declump-by-shape with suppression radius 7 —
    ``min_distance`` plays that radius's role).  ``device=None`` runs on
    the CUDA card (and raises if there is none).
    """
    dev = resolve_device(device)
    img = torch.as_tensor(img, device=dev).to(torch.float32)
    th = white_tophat(img, tophat_size)
    enh = enhance_speckles(th, feature_size)
    if threshold is None:
        if threshold_method == "li":
            threshold = li_threshold(enh, correction=threshold_correction,
                                     bounds=threshold_bounds)
        else:
            threshold = otsu_threshold(enh)
    thr = torch.as_tensor(threshold, device=dev)[..., None, None]
    # local maxima: value equals the neighbourhood max and exceeds thr
    neigh_max = _morph(enh, 2 * min_distance + 1, "max")
    mask = (enh >= neigh_max - 1e-12) & (enh > thr)
    return PunctaResult(count=mask.sum(dim=(-2, -1)), mask=mask,
                        enhanced=enh)


# --- per-cell quantification ---------------------------------------------
#
# The pipelines do not stop at an image-level puncta count: they identify
# cells (IdentifyPrimaryObjects "Cells_mvHRas", module 14: MCE threshold,
# correction 1.08, smoothing 10, no declumping; or nuclei-seeded
# IdentifySecondaryObjects "Propagation", module 53) and relate puncta to
# their enclosing cell (RelateObjects module 64 ->
# ``Children_PLA_primary_objects_Count`` per cell).  The equivalents below
# are label propagation by iterated masked 3x3 max-dilation to a fixpoint.


def _check_labels(max_label: int) -> None:
    if max_label > MAX_LABEL:
        raise ValueError(
            f"labels up to {max_label} exceed {MAX_LABEL} (2**24), the "
            "largest integer that float32 max-pooling carries exactly")


def _propagate_labels(labels: torch.Tensor, mask: torch.Tensor, *,
                      flood: bool = False) -> torch.Tensor:
    """Propagate labels through ``mask`` by iterated 3x3 dilation until
    a fixpoint.

    ``flood=True``: every pixel takes the max label in its neighbourhood
    — with pixel-index seeds this computes connected components (each
    component converges to its max index).  ``flood=False``: only
    UNLABELED masked pixels take a neighbour's label; existing labels are
    frozen, so sparse seeds grow as fronts and each pixel ends with its
    geodesically nearest seed (ties at the contact line -> larger label).
    This is the front propagation CellProfiler's "Propagation"
    secondary-object method performs (regularization 0).

    The fixpoint is checked every :data:`FIXPOINT_CHECK_EVERY`
    dilations, one host sync each; the result is the JAX package's,
    which checks after every dilation, because a fixpoint stays one.
    Returns int32 labels.
    """
    mask = torch.as_tensor(mask, device=labels.device).to(torch.bool)
    if labels.numel():
        _check_labels(int(labels.max()))
    lab = torch.where(mask, labels, 0).to(torch.float32)

    def step(lab):
        grown = _morph(lab, 3, "max")
        new = torch.maximum(lab, grown) if flood else torch.where(
            lab > 0, lab, grown)
        return torch.where(mask, new, 0.0)

    while True:
        for _ in range(FIXPOINT_CHECK_EVERY - 1):
            lab = step(lab)
        new = step(lab)
        if torch.equal(new, lab):
            return new.to(torch.int32)
        lab = new


def identify_cells(img, *, smoothing_scale: float = 10.0,
                   threshold_correction: float = 1.08,
                   seeds=None, device=None) -> torch.Tensor:
    """Label cell regions in a cytoplasmic/membrane-marker image.

    Mirrors ``IdentifyPrimaryObjects`` "Cells_mvHRas" (module 14 of the
    GAB1-SHP2 pipeline: Gaussian smoothing (size 10), global Minimum
    Cross-Entropy threshold with correction factor 1.08, clumped-object
    separation "None") on (H, W) or (batch, H, W) images.  With
    ``seeds`` (an int label image of nuclei/markers, 0 = background) the
    cell mask is partitioned by geodesic label propagation instead — the
    "Propagation" ``IdentifySecondaryObjects`` route (module 53).

    Returns an int32 label image; 0 is background.  Labels are arbitrary
    positive ints (pixel-index based for the unseeded route, so an image
    may hold at most 2**24 pixels); compact them on the host with
    :func:`puncta_per_cell`.  ``device=None`` runs on the CUDA card (and
    raises if there is none).
    """
    dev = resolve_device(device)
    img = torch.as_tensor(img, device=dev).to(torch.float32)
    smooth = gaussian_blur(img, smoothing_scale / 2.35)
    thr = li_threshold(smooth, correction=threshold_correction)
    mask = smooth > thr[..., None, None]
    if seeds is None:
        h, w = img.shape[-2:]
        _check_labels(h * w)
        seeds = 1 + torch.arange(h * w, dtype=torch.int32,
                                 device=dev).reshape(h, w)
        return _propagate_labels(seeds.expand(img.shape), mask, flood=True)
    seeds = torch.as_tensor(seeds, device=dev).expand(img.shape)
    return _propagate_labels(seeds, mask, flood=False)


class PerCellCounts(NamedTuple):
    cell_ids: np.ndarray     # (n_cells,) compacted cell ids (1..n)
    counts: np.ndarray       # (n_cells,) puncta per cell
    areas: np.ndarray        # (n_cells,) cell pixel areas
    n_unassigned: int        # puncta outside every cell


def puncta_per_cell(cell_labels, puncta_mask, *, min_area: int = 0
                    ) -> PerCellCounts:
    """Relate puncta to cells: per-cell puncta counts (host-side numpy).

    The counting equivalent of ``RelateObjects`` (module 64, parent
    ``Cells_mvHRas_2ndry`` / child ``PLA_primary_objects``) -> the
    pipelines' exported ``Children_PLA_primary_objects_Count``.
    ``min_area`` drops labels smaller than the pipelines' minimum cell
    diameter (module 14 discards objects outside 200-4000 px diameter).
    The per-cell table is analysis output, not hot-path compute."""
    L = torch.as_tensor(cell_labels).cpu().numpy()
    M = torch.as_tensor(puncta_mask).cpu().numpy().astype(bool)
    ids, inverse, areas = np.unique(L, return_inverse=True,
                                    return_counts=True)
    hit = np.bincount(inverse.reshape(L.shape)[M], minlength=len(ids))
    keep = (ids > 0) & (areas >= min_area)
    n_unassigned = int(M.sum() - hit[keep].sum())
    return PerCellCounts(
        cell_ids=np.arange(1, keep.sum() + 1),
        counts=hit[keep].astype(int),
        areas=areas[keep].astype(int),
        n_unassigned=n_unassigned,
    )


def count_puncta_per_cell(pla_img, cell_img, *,
                          feature_size: float = 10.0, tophat_size: int = 11,
                          min_distance: int = 3,
                          threshold_method: str = "li",
                          threshold_correction: float = 0.2,
                          threshold_bounds=(0.2, 1.0),
                          cell_smoothing_scale: float = 10.0,
                          cell_threshold_correction: float = 1.08,
                          seeds=None, min_cell_area: int = 0,
                          device=None) -> PerCellCounts:
    """Full per-cell PLA quantification on one (H, W) image pair.

    ``pla_img`` is the PLA channel, ``cell_img`` the cell-marker (mvHRas)
    channel.  Defaults follow the GAB1-SHP2 40x pipeline's shipped
    parameterization (see :func:`count_puncta` / :func:`identify_cells`
    for the module-by-module mapping).  ``device=None`` runs on the CUDA
    card (and raises if there is none)."""
    res = count_puncta(pla_img, feature_size=feature_size,
                       tophat_size=tophat_size, min_distance=min_distance,
                       threshold_method=threshold_method,
                       threshold_correction=threshold_correction,
                       threshold_bounds=threshold_bounds, device=device)
    labels = identify_cells(cell_img, smoothing_scale=cell_smoothing_scale,
                            threshold_correction=cell_threshold_correction,
                            seeds=seeds, device=device)
    return puncta_per_cell(labels, res.mask, min_area=min_cell_area)
