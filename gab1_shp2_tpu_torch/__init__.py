"""PyTorch/CUDA port of the gab1_shp2_tpu reaction-diffusion framework.

A second package beside the JAX reference (``gab1_shp2_tpu``), with the
same module names.  It imports torch and numpy only, never jax or the JAX
package.  Public functions keep the JAX package's lane-minor layout: a
state is (NB, 10, B) and a Jacobian band (NB, 10, 10, B), with the
ensemble (lane) axis last.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; a missing card raises.

TF32 is switched off for matmuls and cuDNN: it keeps ~3 decimal digits,
which would ruin the f32 block cyclic reduction.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gab1_shp2_tpu_torch.models.params import (  # noqa: E402
    Params,
    default_co,
    default_params,
    hela_co,
    resolve_device,
)
from gab1_shp2_tpu_torch.models.system import (  # noqa: E402
    Geometry,
    ReactionDiffusionSystem,
    base_system,
    memb_sfk_system,
    rect_system,
)
from gab1_shp2_tpu_torch.ops.batch_stiff import (  # noqa: E402
    solve_stiff_batch,
    solve_stiff_refill,
)
from gab1_shp2_tpu_torch.ops.explicit import solve_explicit  # noqa: E402
from gab1_shp2_tpu_torch.ops.trbdf2 import solve_stiff  # noqa: E402
from gab1_shp2_tpu_torch.ensemble.engine import (  # noqa: E402
    masked_quantiles,
    run_ensemble,
)

__all__ = [
    "Params",
    "default_co",
    "default_params",
    "hela_co",
    "resolve_device",
    "Geometry",
    "ReactionDiffusionSystem",
    "base_system",
    "memb_sfk_system",
    "rect_system",
    "solve_stiff",
    "solve_stiff_batch",
    "solve_stiff_refill",
    "solve_explicit",
    "run_ensemble",
    "masked_quantiles",
]
