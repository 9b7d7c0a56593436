"""CUDA C++ rate functions generated from the reaction tables.

Both hand-written kernels (``csrc/ros23_step.cu`` and
``csrc/explicit_solve.cu``) include the header that :func:`rates_header`
generates at build time from a system's reaction tables
(``models/system.py``): templates ``bulk_rates``, ``memb_rates`` and
``bc_closure`` over a value type ``V`` (``float``, or a dual number for
derivatives), with the expression order of the eager code in
``ops/rhs.py``.
"""

from __future__ import annotations

from gab1_shp2_tpu_torch.models.species import CYTO, K_NAMES, MEMB, N_CYTO
from gab1_shp2_tpu_torch.models.system import (
    ETOT_MEMBERS,
    ETOT_SCALE,
    ReactionDiffusionSystem,
)

_K = {n: i for i, n in enumerate(K_NAMES)}


def _product(factors):
    """C++ for a left-to-right product chain (the eager order)."""
    expr = factors[0]
    for f in factors[1:]:
        expr = f"({expr} * {f})"
    return expr


def _reaction_lines(reactions, conc, out):
    """C++ statements accumulating mass-action net rates into ``out``,
    in the order of ``rhs._net_reaction_terms``."""
    lines = []
    for rx in reactions:
        rf = [f"V(k[{_K[rx.kf]}])"]
        if rx.rate_scale is not None:
            rf.append(f"V(k[{_K[rx.rate_scale]}])")
        for s, st in zip(rx.reactants, rx.r_stoich()):
            rf.append(conc(s) if st == 1 else _product([conc(s)] * st))
        rf += [conc(s) for s in rx.catalysts]
        lines.append("  {")
        lines.append(f"    const V rf = {_product(rf)};")
        if rx.kr is not None:
            rr = [f"V(k[{_K[rx.kr]}])"]
            for s, st in zip(rx.products, rx.p_stoich()):
                rr.append(conc(s) if st == 1 else _product([conc(s)] * st))
            lines.append(f"    const V net = rf - {_product(rr)};")
        else:
            lines.append("    const V net = rf;")
        for s, st in zip(rx.reactants, rx.r_stoich()):
            term = "net" if st == 1 else f"(V({float(st)}f) * net)"
            lines.append(f"    {out(s)} = {out(s)} - {term};")
        for s, st in zip(rx.products, rx.p_stoich()):
            term = "net" if st == 1 else f"(V({float(st)}f) * net)"
            lines.append(f"    {out(s)} = {out(s)} + {term};")
        lines.append("  }")
    return lines


def rates_header(system: ReactionDiffusionSystem) -> str:
    """C++ templates ``bulk_rates``, ``memb_rates`` and ``bc_closure``
    over a value type V (float or a dual number), generated from the
    system's reaction tables with the eager code's expression order."""
    L = ["// Generated from the reaction tables of "
         "gab1_shp2_tpu_torch/models/system.py",
         "// by gab1_shp2_tpu_torch/ops/ros23_cuda.py:rates_header.",
         "#pragma once", ""]
    L += ["template <typename V>",
          "__device__ __forceinline__ void bulk_rates(const V* C, "
          "const float* k, V* out) {",
          "#pragma unroll",
          f"  for (int s = 0; s < {N_CYTO}; ++s) out[s] = V(0.0f);"]
    L += _reaction_lines(system.bulk_reactions, lambda s: f"C[{CYTO[s]}]",
                         lambda s: f"out[{CYTO[s]}]")
    L += ["}", ""]

    L += ["template <typename V>",
          "__device__ __forceinline__ void memb_rates(const V* m, "
          "const V* CR, const float* k, V* out) {",
          "#pragma unroll",
          f"  for (int s = 0; s < {len(MEMB)}; ++s) out[s] = V(0.0f);"]
    L += _reaction_lines(system.memb_reactions, lambda s: f"m[{MEMB[s]}]",
                         lambda s: f"out[{MEMB[s]}]")
    for sb in system.surface_bindings:
        mi, pi = MEMB[sb.memb], MEMB[sb.product]
        L += ["  {",
              f"    const V net = ((V(k[{_K[sb.kf]}]) * CR[{CYTO[sb.cyto]}])"
              f" * m[{mi}]) - (V(k[{_K[sb.kr]}]) * m[{pi}]);",
              f"    out[{mi}] = out[{mi}] - net;",
              f"    out[{pi}] = out[{pi}] + net;",
              "  }"]
    L += ["}", ""]

    etot_terms = [f"m[{MEMB[s]}]" for s in ETOT_MEMBERS]
    etot_sum = etot_terms[0]
    for t in etot_terms[1:]:
        etot_sum = f"({etot_sum} + {t})"
    iS, aS = CYTO["iSFK"], CYTO["aSFK"]
    L += ["template <typename V>",
          "__device__ __forceinline__ void bc_closure(const V* cn, "
          "const V* m, const float* k, const float* de, float dr, V* CR) {",
          f"  V g[{N_CYTO}], l[{N_CYTO}];",
          "#pragma unroll",
          f"  for (int s = 0; s < {N_CYTO}; ++s) {{ g[s] = V(0.0f); "
          "l[s] = V(0.0f); }"]
    for sb in system.surface_bindings:
        ci = CYTO[sb.cyto]
        L += [f"  g[{ci}] = g[{ci}] + V(k[{_K[sb.kr]}]) * "
              f"m[{MEMB[sb.product]}];",
              f"  l[{ci}] = l[{ci}] + V(k[{_K[sb.kf]}]) * "
              f"m[{MEMB[sb.memb]}];"]
    L += [f"  const V Et = V({float(ETOT_SCALE)}f) * {etot_sum};",
          f"  l[{iS}] = l[{iS}] + V(k[{_K['kSa']}]) * Et;",
          "#pragma unroll",
          f"  for (int s = 0; s < {N_CYTO}; ++s)",
          "    CR[s] = (cn[s] + g[s] * dr / de[s]) / "
          "(V(1.0f) + l[s] * dr / de[s]);",
          "  // aSFK: produced at the surface at the iSFK consumption rate",
          f"  CR[{aS}] = cn[{aS}] + V(k[{_K['kSa']}]) * CR[{iS}] * Et * dr"
          f" / de[{aS}];",
          "}", ""]
    return "\n".join(L)
