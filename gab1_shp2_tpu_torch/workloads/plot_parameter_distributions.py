"""Parameter-ensemble generation and distribution plots (port of
``Julia/plot_parameter_distributions.jl``).

Counterpart of ``gab1_shp2_tpu/workloads/plot_parameter_distributions.py``:
generates an N-member prior+posterior ensemble, writes
``parameter_ensemble.csv`` (the artifact the reference's MATLAB scripts
consume), and renders prior-vs-posterior distribution plots.  No solve
runs here, so there is no device to choose; ``--cpu`` is accepted and
changes nothing.

    python -m gab1_shp2_tpu_torch.workloads.plot_parameter_distributions
"""

from __future__ import annotations

import os

import numpy as np

from gab1_shp2_tpu_torch.models.species import PNAMES
from gab1_shp2_tpu_torch.priors.posteriors import (
    generate_ensemble,
    load_chain_csv,
)
from gab1_shp2_tpu_torch.workloads import common


def main(argv=None):
    ap = common.default_argparser(__doc__)
    ap.set_defaults(n=5000)
    args = ap.parse_args(argv)
    out = args.outdir
    os.makedirs(out, exist_ok=True)

    chain = None
    if os.path.exists(common.REFERENCE_CHAIN):
        chain = load_chain_csv(common.REFERENCE_CHAIN)
    ens = generate_ensemble(chain, n=args.n,
                            rng=np.random.default_rng(args.seed))
    common.save_csv(f"{out}/parameter_ensemble.csv", list(PNAMES),
                    ens.tolist())
    print(f"wrote {args.n}x24 parameter_ensemble.csv")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(4, 6, figsize=(18, 10))
    for j, (ax, name) in enumerate(zip(axes.ravel(), PNAMES)):
        vals = np.log10(ens[:, j])
        ax.hist(vals, bins=40, density=True, alpha=0.7)
        ax.set_title(name, fontsize=9)
        ax.set_xlabel("log10 value", fontsize=7)
    fig.tight_layout()
    fig.savefig(f"{out}/parameter_distributions.png", dpi=130)
    plt.close(fig)
    print("wrote parameter_distributions.png")


if __name__ == "__main__":
    main()
