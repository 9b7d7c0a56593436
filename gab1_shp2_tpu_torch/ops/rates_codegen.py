"""CUDA C++ rate functions generated from the reaction tables.

Both hand-written kernels (``csrc/ros23_step.cu`` and
``csrc/explicit_solve.cu``) include the header that :func:`rates_header`
generates at build time from a system's reaction tables
(``models/system.py``): templates ``bulk_rates``, ``memb_rates`` and
``bc_closure`` over a value type ``V`` (``float``, or a dual number for
derivatives), with the expression order of the eager code in
``ops/rhs.py``.  The explicit kernel also includes
:func:`lane_closure_header`: the membrane fixed point spread over the
lanes of a warp, with its loop invariants hoisted.
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


def _lane_table(values, width=32, fill=0):
    """C++ initializer for a per-lane table padded to a warp's width."""
    vals = list(values) + [fill] * (width - len(values))
    return "{" + ", ".join(str(v) for v in vals) + "}"


def lane_closure_header(system: ReactionDiffusionSystem) -> str:
    """CUDA C++ for the membrane fixed point of the explicit kernel
    (``csrc/explicit_solve.cu``) spread over the lanes of one warp, with
    its loop invariants hoisted.

    Lane s < 10 holds bulk species s and the one surface binding whose
    bulk partner it is (the generator refuses a system where a species
    has two, or where iSFK or aSFK has one); lane i < 8 holds membrane
    species i.  The header has the per-lane tables, ``etot_lanes``,
    ``memb_reaction_rates`` (the membrane reactions alone: with the
    previous step's state fixed they do not change between iterations),
    ``closure_quotient`` (one lane's quotient ``(cn + g q) / (1 + l q)``
    with ``q = dr / d_eff`` hoisted, taken by ``div_by`` with the
    correctly rounded reciprocal ``rcp_rn``), ``closure_boundary``
    (the lane's boundary value: the same quotient with iSFK's loss ``kSa
    Etot``, and aSFK's ``cn + kSa q CR[iSFK] Etot``) and ``memb_dm_lane``
    (one membrane lane's rate: the membrane reactions, then the binding
    nets in the order of the binding table, as ``memb_rates`` sums them).
    Etot enters only iSFK's and aSFK's boundary values, and no binding
    reads those, so the iterations' chain needs ``closure_quotient``
    alone.  The including source defines ``FULL`` and includes
    ``csrc/fast_div.cuh`` (``div_by``, ``rcp_rn``) first.
    ``bc_closure`` of :func:`rates_header` is left as it is.
    """
    bind = {}
    for sb in system.surface_bindings:
        ci = CYTO[sb.cyto]
        if ci in bind:
            raise ValueError(f"{sb.cyto} has two surface bindings; the lane "
                             "layout of the explicit kernel takes one")
        bind[ci] = sb
    for name in ("iSFK", "aSFK"):
        if CYTO[name] in bind:
            raise ValueError(f"{name} has a surface binding; the explicit "
                             "kernel's iterations leave Etot out of the "
                             "bindings' chain")
    kf = [_K[bind[s].kf] if s in bind else -1 for s in range(N_CYTO)]
    kr = [_K[bind[s].kr] if s in bind else -1 for s in range(N_CYTO)]
    memb = [MEMB[bind[s].memb] if s in bind else 0 for s in range(N_CYTO)]
    prod = [MEMB[bind[s].product] if s in bind else 0 for s in range(N_CYTO)]
    terms = {i: [] for i in range(len(MEMB))}
    for sb in system.surface_bindings:
        terms[MEMB[sb.memb]].append((CYTO[sb.cyto], "-1.0f"))
        terms[MEMB[sb.product]].append((CYTO[sb.cyto], "1.0f"))
    nt = max(len(t) for t in terms.values())
    src = [[terms[i][t][0] if t < len(terms[i]) else 0 for i in terms]
           for t in range(nt)]
    sgn = [[terms[i][t][1] if t < len(terms[i]) else "0.0f" for i in terms]
           for t in range(nt)]
    etot = [f"__shfl_sync(FULL, mm, {MEMB[s]})" for s in ETOT_MEMBERS]
    etot_sum = etot[0]
    for t in etot[1:]:
        etot_sum = f"({etot_sum} + {t})"

    L = ["// Generated from the reaction tables of "
         "gab1_shp2_tpu_torch/models/system.py",
         "// by gab1_shp2_tpu_torch/ops/rates_codegen.py:lane_closure_header.",
         "#pragma once", "",
         f"constexpr int LANE_ISFK = {CYTO['iSFK']};",
         f"constexpr int LANE_ASFK = {CYTO['aSFK']};",
         f"constexpr int K_SA = {_K['kSa']};",
         f"constexpr int NET_TERMS = {nt};",
         "// lane s < 10: k indices of the on and off rates of the binding "
         "whose bulk",
         "// partner is species s (-1: none), and the lanes of its free and "
         "bound",
         "// membrane species",
         f"__constant__ int BIND_KF[32] = {_lane_table(kf, fill=-1)};",
         f"__constant__ int BIND_KR[32] = {_lane_table(kr, fill=-1)};",
         f"__constant__ int BIND_MEMB[32] = {_lane_table(memb)};",
         f"__constant__ int BIND_PROD[32] = {_lane_table(prod)};",
         "// membrane lane i < 8: the lanes whose binding nets it takes, in "
         "the",
         "// binding table's order, and their signs (0: no term)",
         f"__constant__ int NET_LANE[{nt}][32] = {{"
         + ", ".join(_lane_table(r) for r in src) + "};",
         f"__constant__ float NET_SIGN[{nt}][32] = {{"
         + ", ".join(_lane_table(r, fill="0.0f") for r in sgn) + "};", "",
         "// what one lane keeps of its species and binding; loop invariants",
         "struct LaneClosure {",
         "  float q;    // dr / d_eff of the lane's bulk species",
         "  float kf;   // binding on rate (0: none)",
         "  float kr;   // binding off rate (0: none)",
         "  float ksa;  // kSa on the iSFK lane, else 0",
         "  float kq;   // kSa * dr / d_eff(aSFK)",
         "  int memb;   // lane of the binding's free membrane species",
         "  int prod;   // lane of its bound membrane species",
         "  bool asfk;  // the aSFK lane",
         "};", "",
         "// Etot of the membrane iterate mm (held by lanes 0..7), on every "
         "lane",
         "__device__ __forceinline__ float etot_lanes(float mm) {",
         f"  return {float(ETOT_SCALE)}f * {etot_sum};",
         "}", "",
         "// the membrane reactions' share of memb_rates, for all 8 species",
         "__device__ __forceinline__ void memb_reaction_rates(const float* m, "
         "const float* k, float* out) {",
         "  typedef float V;",
         "#pragma unroll",
         f"  for (int s = 0; s < {len(MEMB)}; ++s) out[s] = 0.0f;"]
    L += _reaction_lines(system.memb_reactions, lambda s: f"m[{MEMB[s]}]",
                         lambda s: f"out[{MEMB[s]}]")
    L += ["}", "",
          "// (cn + g q) / (1 + l q) for the lane's species",
          "__device__ __forceinline__ float lane_quotient(float cn, float g, "
          "float l,",
          "                                              const LaneClosure& "
          "c) {",
          "  const float num = fmaf(g, c.q, cn);",
          "  const float den = fmaf(l, c.q, 1.0f);",
          "  return div_by(num, den, rcp_rn(den));",
          "}", "",
          "// lane s < 10: the quotient from C_near[s] (cn) and the membrane "
          "iterate mm,",
          "// g = kr m[prod], l = kf m[memb]: what the bindings' nets read",
          "__device__ __forceinline__ float closure_quotient(float cn, float "
          "mm,",
          "                                                 const "
          "LaneClosure& c) {",
          "  return lane_quotient(cn, c.kr * __shfl_sync(FULL, mm, c.prod),",
          "                       c.kf * __shfl_sync(FULL, mm, c.memb), c);",
          "}", "",
          "// CR[s] on lane s < 10: the quotient with iSFK's loss kSa Etot; "
          "on the aSFK",
          "// lane cn + kSa q CR[iSFK] Etot",
          "__device__ __forceinline__ float closure_boundary(float cn, float "
          "mm, float Et,",
          "                                                 const "
          "LaneClosure& c) {",
          "  const float cr = lane_quotient(",
          "      cn, c.kr * __shfl_sync(FULL, mm, c.prod),",
          "      fmaf(c.ksa, Et, c.kf * __shfl_sync(FULL, mm, c.memb)), c);",
          "  const float cr_isfk = __shfl_sync(FULL, cr, LANE_ISFK);",
          "  return c.asfk ? fmaf(c.kq * cr_isfk, Et, cn) : cr;",
          "}", "",
          "// dm[i] on membrane lane i < 8: the membrane reactions' rate R, "
          "then the",
          "// binding nets (held by the bulk species' lanes) in table order",
          "__device__ __forceinline__ float memb_dm_lane(float net, float R, "
          "const int* src,",
          "                                             const float* sgn) {",
          "  float dm = R;",
          "#pragma unroll",
          "  for (int t = 0; t < NET_TERMS; ++t)",
          "    dm = fmaf(sgn[t], __shfl_sync(FULL, net, src[t]), dm);",
          "  return dm;",
          "}", ""]
    return "\n".join(L)
