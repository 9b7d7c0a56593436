"""The port's PLA puncta quantification (gab1_shp2_tpu_torch.imaging.puncta)
against the JAX package on the CPU, and the JAX package's behaviour checks
(``tests/test_imaging.py``) run on the port.

Tolerances.  Seeded synthetic images of 64^2-160^2 pixels (spots on a
sloped background, disk "cells"), float32.  Gaussian blur and the
difference of Gaussians within 1e-5 of the largest value (the port sums
the filter's taps in a fixed order, the JAX package by a convolution;
~3e-7 seen); the top-hat is exact (min and max only).  Otsu and Li
thresholds within 1e-5 relative (the port accumulates their statistics
in float64; ~1e-7 seen).  Masks, counts and labels equal.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gab1_shp2_tpu.imaging import puncta as jp

from gab1_shp2_tpu_torch.imaging import puncta as tp
from tests.test_imaging import synthetic_cells, synthetic_image

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def plate():
    """Three 128^2 spot images (5, 15 and 30 spots) and their counts."""
    rng = np.random.default_rng(1)
    imgs, counts = [], []
    for n in (5, 15, 30):
        im, pts = synthetic_image(rng, n_spots=n)
        imgs.append(im)
        counts.append(len(pts))
    return np.stack(imgs), counts


@pytest.fixture(scope="module")
def cells():
    return synthetic_cells(np.random.default_rng(5))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


@pytest.mark.parametrize("sigma", [0.8, 2.0, 10.0])
def test_gaussian_blur_matches_jax(plate, sigma):
    imgs, _ = plate
    _close(tp.gaussian_blur(torch.as_tensor(imgs), sigma).numpy(),
           jp.gaussian_blur(jnp.asarray(imgs), sigma), 1e-5)


@pytest.mark.parametrize("size", [3, 10, 11])
def test_white_tophat_matches_jax(plate, size):
    imgs, _ = plate
    np.testing.assert_array_equal(
        tp.white_tophat(torch.as_tensor(imgs), size).numpy(),
        np.asarray(jp.white_tophat(jnp.asarray(imgs), size)))


def test_dog_and_thresholds_match_jax(plate):
    imgs, _ = plate
    et = tp.enhance_speckles(tp.white_tophat(torch.as_tensor(imgs), 11), 8.0)
    ej = jp.enhance_speckles(jp.white_tophat(jnp.asarray(imgs), 11), 8.0)
    _close(et.numpy(), ej, 1e-5)
    np.testing.assert_allclose(tp.otsu_threshold(et).numpy(),
                               np.asarray(jp.otsu_threshold(ej)), rtol=1e-5)
    np.testing.assert_allclose(tp.li_threshold(et).numpy(),
                               np.asarray(jp.li_threshold(ej)), rtol=1e-5)
    kw = dict(correction=0.2, bounds=(0.2, 1.0), smoothing_scale=3.0)
    np.testing.assert_allclose(tp.li_threshold(et, **kw).numpy(),
                               np.asarray(jp.li_threshold(ej, **kw)),
                               rtol=1e-5)


@pytest.mark.parametrize("method", ["otsu", "li"])
def test_count_puncta_matches_jax(plate, method):
    imgs, _ = plate
    kw = dict(feature_size=8.0, min_distance=4, threshold_method=method)
    if method == "li":
        kw.update(threshold_correction=0.2, threshold_bounds=(0.2, 1.0))
    rt = tp.count_puncta(imgs, device="cpu", **kw)
    rj = jp.count_puncta(jnp.asarray(imgs), **kw)
    np.testing.assert_array_equal(rt.count.numpy(), np.asarray(rj.count))
    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    _close(rt.enhanced.numpy(), rj.enhanced, 1e-5)


def test_identify_cells_and_per_cell_counts_match_jax(cells):
    cell, pla, seeds, _ = cells
    np.testing.assert_array_equal(
        tp.identify_cells(cell, device="cpu").numpy(),
        np.asarray(jp.identify_cells(jnp.asarray(cell))))
    np.testing.assert_array_equal(
        tp.identify_cells(cell, seeds=seeds, device="cpu").numpy(),
        np.asarray(jp.identify_cells(jnp.asarray(cell),
                                     seeds=jnp.asarray(seeds))))
    kw = dict(feature_size=6.0, min_distance=4)
    got = tp.count_puncta_per_cell(pla, cell, device="cpu", **kw)
    want = jp.count_puncta_per_cell(pla, cell, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_propagation_partitions_touching_cells_like_jax():
    """Two touching disks: connected components would merge them; seed
    propagation (the module-53 'Propagation' route) splits the mask at
    the geodesic midline, as in the JAX package."""
    H = W = 96
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    mask = np.zeros((H, W), bool)
    mask |= (yy - 48) ** 2 + (xx - 34) ** 2 < 20**2
    mask |= (yy - 48) ** 2 + (xx - 62) ** 2 < 20**2
    seeds = np.zeros((H, W), np.int32)
    seeds[48, 34] = 1
    seeds[48, 62] = 2
    labels = tp._propagate_labels(torch.as_tensor(seeds),
                                  torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(
        labels, np.asarray(jp._propagate_labels(jnp.asarray(seeds),
                                                jnp.asarray(mask))))
    assert labels.dtype == np.int32
    assert set(np.unique(labels)) == {0, 1, 2}
    a1, a2 = (labels == 1).sum(), (labels == 2).sum()
    assert abs(a1 - a2) < 0.25 * (a1 + a2)
    assert (labels > 0).sum() == mask.sum()
    # flood fill of pixel-index seeds: one label per connected component
    flood = tp._propagate_labels(
        torch.arange(1, H * W + 1, dtype=torch.int32).reshape(H, W),
        torch.as_tensor(mask), flood=True).numpy()
    assert len(np.unique(flood[flood > 0])) == 1


def test_labels_beyond_float32_raise():
    seeds = torch.zeros((4, 4), dtype=torch.int32)
    seeds[1, 1] = (1 << 24) + 1
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tp._propagate_labels(seeds, torch.ones((4, 4), dtype=torch.bool))


def test_counts_synthetic_spots():
    img, _ = synthetic_image(np.random.default_rng(0), n_spots=25)
    res = tp.count_puncta(img, feature_size=8.0, min_distance=4,
                          device="cpu")
    # within 10% of ground truth despite background + noise
    assert abs(int(res.count) - 25) <= 3


def test_batched(plate):
    imgs, counts = plate
    got = tp.count_puncta(imgs, feature_size=8.0, min_distance=4,
                          device="cpu").count.numpy()
    assert got.shape == (3,)
    assert got[0] < got[1] < got[2]
    for g, want in zip(got, counts):
        assert abs(int(g) - want) <= max(3, int(0.2 * want))


def test_tophat_removes_gradient():
    xx = np.linspace(0, 1, 64, dtype=np.float32)
    img = torch.as_tensor(np.broadcast_to(xx, (64, 64)).copy())
    assert float(tp.white_tophat(img, 11).max()) < 0.2


def _bimodal(seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.concatenate([
        rng.normal(0.2, 0.02, 2000),
        rng.normal(0.8, 0.02, 500)]).reshape(50, 50).astype(np.float32))


def test_thresholds_separate_bimodal():
    img = _bimodal(3)
    t = float(tp.li_threshold(img))
    assert 0.22 < t < 0.78
    assert abs(int((img > t).sum()) - 500) < 10
    # bounds clip like CellProfiler's lower/upper bounds (applied in the
    # normalized [min, max] intensity range)
    t_lo = float(tp.li_threshold(img, bounds=(0.9, 1.0)))
    assert t_lo >= float(img.min() + 0.9 * (img.max() - img.min())) - 1e-3
    img = _bimodal(2)
    t = float(tp.otsu_threshold(img))
    assert 0.22 < t < 0.78
    assert abs(int((img > t).sum()) - 500) < 10


def test_identify_cells_finds_components(cells):
    labels = tp.identify_cells(cells[0], device="cpu").numpy()
    ids = np.unique(labels[labels > 0])
    assert len(ids) == 3
    areas = sorted(int((labels == i).sum()) for i in ids)
    assert areas[0] > 800 and areas[-1] < 4000


def test_per_cell_counts_match_truth(cells):
    cell, pla, seeds, truth = cells
    res = tp.count_puncta_per_cell(pla, cell, feature_size=6.0,
                                   min_distance=4, device="cpu")
    assert sorted(res.counts) == sorted(truth.values())
    # an extra punctum in the background lands in n_unassigned
    yy, xx = np.mgrid[0:160, 0:160].astype(np.float64)
    pla = pla + 1.0 * np.exp(-((yy - 8) ** 2 + (xx - 150) ** 2)
                             / (2 * 1.5**2))
    res = tp.count_puncta_per_cell(pla.astype(np.float32), cell,
                                   feature_size=6.0, min_distance=4,
                                   seeds=seeds, device="cpu")
    assert sorted(res.counts) == sorted(truth.values())
    assert res.n_unassigned >= 1


@pytest.mark.parametrize("name", ["count_puncta", "li_threshold",
                                  "otsu_threshold", "identify_cells",
                                  "count_puncta_per_cell", "puncta_per_cell",
                                  "white_tophat", "enhance_speckles"])
def test_defaults_match_jax(name):
    """The keyword defaults equal the JAX package's, which its own test
    holds against the shipped CellProfiler pipeline; the port adds only
    ``device``."""
    def defaults(fn):
        fn = getattr(fn, "__wrapped__", fn)
        return {k: p.default for k, p in
                inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    got = defaults(getattr(tp, name))
    assert got.pop("device", None) is None
    assert got == defaults(getattr(jp, name))


def test_entry_points_default_to_the_card():
    img = np.zeros((8, 8), np.float32)
    if torch.cuda.is_available():
        assert tp.count_puncta(img).mask.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tp.count_puncta(img)
