"""Species registry for the GAB1-SHP2/EGFR reaction-diffusion model.

Ten cytosolic (bulk) species diffuse in the cell volume; eight
membrane-bound EGFR states live on the boundary r = R and couple to the
cytosol through reactive-flux (Robin) boundary conditions.

Parity notes: species sets and orderings mirror the reference solver's
state variables (reference ``Julia/basepdesolver.jl:113-133``), but the
ordering here is an internal layout choice — all public APIs use names.
"""

from __future__ import annotations

# --- Cytosolic (bulk) species: rows of the (10, n_nodes) state array ---
CYTO_SPECIES = (
    "iSFK",  # inactive SFK
    "aSFK",  # active SFK
    "GAB1",
    "pGAB1",
    "GRB2",
    "G2G1",  # GRB2-GAB1
    "G2PG1",  # GRB2-pGAB1
    "SHP2",
    "PG1S",  # pGAB1-SHP2
    "G2PG1S",  # GRB2-pGAB1-SHP2
)

# --- Membrane species: entries of the (8,) membrane state vector ---
MEMB_SPECIES = (
    "mE",  # unbound EGFR monomer
    "mES",  # EGF-bound EGFR monomer
    "mESmES",  # unphosphorylated dimer
    "E",  # phosphorylated dimer (pEGFR), free
    "EG2",  # pEGFR-GRB2
    "EG2G1",  # pEGFR-GRB2-GAB1
    "EG2PG1",  # pEGFR-GRB2-pGAB1
    "EG2PG1S",  # pEGFR-GRB2-pGAB1-SHP2
)

N_CYTO = len(CYTO_SPECIES)
N_MEMB = len(MEMB_SPECIES)

CYTO = {name: i for i, name in enumerate(CYTO_SPECIES)}
MEMB = {name: i for i, name in enumerate(MEMB_SPECIES)}

# Diffusivity slots: the reference uses a 7-vector of diffusivities
# (reference ``Julia/basepdesolver.jl:43-49``): SFK (shared by iSFK/aSFK),
# GRB2, GRB2-GAB1, GRB2-GAB1-SHP2, GAB1, GAB1-SHP2, SHP2.  This maps each
# cytosolic species to its slot in that vector.
DIFF_NAMES = ("Dsfk", "Dg2", "Dg2g1", "Dg2g1s2", "Dg1", "Dg1s2", "Ds2")
DIFF_SLOT_OF_CYTO = (
    0,  # iSFK  -> Dsfk
    0,  # aSFK  -> Dsfk (pinned to ~0 in the membrane-confined-SFK variant)
    4,  # GAB1  -> Dg1
    4,  # pGAB1 -> Dg1
    1,  # GRB2  -> Dg2
    2,  # G2G1  -> Dg2g1
    2,  # G2PG1 -> Dg2g1
    6,  # SHP2  -> Ds2
    5,  # PG1S  -> Dg1s2
    3,  # G2PG1S-> Dg2g1s2
)

# Kinetic parameter ordering (reference ``Julia/basepdesolver.jl:52-68``).
K_NAMES = (
    "kS2f", "kS2r", "kG1f", "kG1r", "kG2f", "kG2r", "kG1p", "kG1dp",
    "kSa", "kSi", "kp", "kdp", "kEGFf", "kEGFr", "EGF", "kdf", "kdr",
)

# Initial-concentration ordering (reference ``Julia/basepdesolver.jl:79``).
CO_NAMES = ("CoSFK", "CoG2", "CoG1", "CoS2", "CoEGFR")

# Full 24-parameter ensemble ordering (reference
# ``Julia/get_param_posteriors.jl:24-26``): 7 diffusivities then 17 ks.
PNAMES = DIFF_NAMES + K_NAMES
