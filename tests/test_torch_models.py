"""The port's model layer (gab1_shp2_tpu_torch.models) against the JAX
package: tables, packed defaults, parameter helpers, the device rule,
and the port's independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models import params as jparams
from gab1_shp2_tpu.models import species as jspecies
from gab1_shp2_tpu.models import system as jsystem
from gab1_shp2_tpu.ops.solution import Solution as JSolution

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models import params as tparams
from gab1_shp2_tpu_torch.models import species as tspecies
from gab1_shp2_tpu_torch.models import system as tsystem
from gab1_shp2_tpu_torch.ops.solution import Solution as TSolution

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", [
    "CYTO_SPECIES", "MEMB_SPECIES", "N_CYTO", "N_MEMB", "CYTO", "MEMB",
    "DIFF_NAMES", "DIFF_SLOT_OF_CYTO", "K_NAMES", "CO_NAMES", "PNAMES"])
def test_species_tables_equal(name):
    assert getattr(tspecies, name) == getattr(jspecies, name)


def test_reaction_tables_equal():
    for name in ("BULK_REACTIONS", "MEMB_REACTIONS", "SURFACE_BINDINGS"):
        t = [dataclasses.astuple(x) for x in getattr(tsystem, name)]
        j = [dataclasses.astuple(x) for x in getattr(jsystem, name)]
        assert t == j, name
    for name in ("D_ASFK_MEMB", "ETOT_MEMBERS", "ETOT_SCALE"):
        assert getattr(tsystem, name) == getattr(jsystem, name)
    for make in ("base_system", "rect_system", "memb_sfk_system"):
        ts, js = getattr(tsystem, make)(), getattr(jsystem, make)()
        assert (ts.geometry.value, ts.memb_sfk, ts.name) == \
            (js.geometry.value, js.memb_sfk, js.name)
        assert [dataclasses.astuple(r) for r in ts.bulk_reactions] == \
            [dataclasses.astuple(r) for r in js.bulk_reactions]


@pytest.mark.parametrize("fit", ["posterior_median", "map", "prior"])
def test_default_params_pack_exactly(fit):
    got = tg.default_params(fit, device="cpu").pack().numpy()
    want = np.asarray(jg.default_params(fit).pack())
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float64


def test_initial_concentrations_exact():
    np.testing.assert_array_equal(tg.default_co(device="cpu").numpy(),
                                  np.asarray(jg.default_co()))
    np.testing.assert_array_equal(tg.hela_co(device="cpu").numpy(),
                                  np.asarray(jg.hela_co()))
    np.testing.assert_array_equal(
        tparams.co_from_copies(1e5, 2e5, 3e5, 4e5, 5e5, R=7.0,
                               device="cpu").numpy(),
        np.asarray(jparams.co_from_copies(1e5, 2e5, 3e5, 4e5, 5e5, R=7.0)))


def test_carry_across_and_helpers():
    jp = jg.default_params("map")
    pj = jparams.Params.unpack(jnp.stack([jp.pack(), 2.0 * jp.pack()]))
    tp = tparams.Params.from_numpy(np.asarray(pj.D), np.asarray(pj.k),
                                   device="cpu")
    np.testing.assert_array_equal(tp.pack().numpy(), np.asarray(pj.pack()))
    np.testing.assert_array_equal(tp.kSa.numpy(), np.asarray(pj.kSa))
    np.testing.assert_array_equal(tp.Dg1.numpy(), np.asarray(pj.Dg1))
    np.testing.assert_array_equal(
        tp.replace(kp=0.0, Dsfk=3.0).pack().numpy(),
        np.asarray(pj.replace(kp=0.0, Dsfk=3.0).pack()))
    np.testing.assert_array_equal(
        tp.scale(kG1p=2.0, Ds2=0.5).pack().numpy(),
        np.asarray(pj.scale(kG1p=2.0, Ds2=0.5).pack()))
    np.testing.assert_allclose(
        tparams.stability_dt(tp, 0.2).numpy(),
        np.asarray(jparams.stability_dt(pj, 0.2)), rtol=1e-15)
    co = np.asarray(jg.hela_co())
    np.testing.assert_array_equal(
        tparams.co_from_numpy(co, dtype=torch.float32, device="cpu").numpy(),
        co.astype(np.float32))
    # replace/scale copy: the original is untouched
    assert float(tp.kp[0]) == float(pj.kp[0])


def test_replace_badname_raises():
    p = tg.default_params(device="cpu")
    with pytest.raises(KeyError):
        p.replace(badname=1.0)
    with pytest.raises(KeyError):
        p.scale(badname=2.0)
    with pytest.raises(AttributeError):
        p.badname  # noqa: B018


def test_solution_outputs_match_jax():
    rng = np.random.default_rng(3)
    C = rng.uniform(0.0, 5.0, (2, 3, 10, 11))
    m = rng.uniform(0.0, 5.0, (2, 3, 8))
    t = np.linspace(0.0, 1.0, 3)
    r = np.linspace(0.0, 10.0, 11)
    co = np.array([4.0, 5.0])
    js = JSolution(*(jnp.asarray(a) for a in (C, m, t, r, co)))
    ts = TSolution(*(torch.as_tensor(a) for a in (C, m, t, r, co)))
    for name in ("PG1Stot", "PG1tot", "pE", "EGFR_SHP2"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-14, err_msg=name)
    np.testing.assert_array_equal(ts.cyto("aSFK").numpy(),
                                  np.asarray(js.cyto("aSFK")))


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.default_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.default_co()
    p = tg.default_params(device="cpu")
    pb = tg.Params(D=p.D[None], k=p.k[None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.solve_stiff_batch(tg.base_system(), tg.default_co(device="cpu"),
                             pb, dr=1.0, tf=0.1, Nts=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.solve_stiff_refill(tg.base_system(),
                              tg.default_co(device="cpu"), pb, dr=1.0,
                              tf=0.1, Nts=1)


def test_import_pulls_in_no_jax():
    """Importing every port module in a fresh interpreter leaves neither
    jax nor the JAX package in sys.modules."""
    code = (
        "import sys\n"
        "import gab1_shp2_tpu_torch\n"
        "import gab1_shp2_tpu_torch.ops.ros23_cuda\n"
        "import gab1_shp2_tpu_torch.ops._build\n"
        "import gab1_shp2_tpu_torch.ops.solution\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
        "or m == 'gab1_shp2_tpu' or m.startswith('gab1_shp2_tpu.')]\n"
        "assert 'gab1_shp2_tpu_torch' in sys.modules\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
