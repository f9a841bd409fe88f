"""llckbdm_tpu_torch — the KBDM / LL-KBDM pipeline in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of the JAX package ``llckbdm_tpu``, which stays the reference: the
same module and public names, native complex tensors, and where the JAX
package ran a Pallas TPU kernel a CUDA kernel built from ``csrc/`` at first
use (ops.cuda_jacobi, ops.cuda_linalg; the TPU tools' two kernels in
ops.cuda_probes, driven by the entry points in ``tools/``).  On a CPU tensor
every kernel wrapper runs its plain PyTorch version instead.  The voxel-grid
layer (mesh, sharded and time-sharded grid fits, the resumable GridRunner)
is ``llckbdm_tpu_torch.parallel``, on torch.distributed.  Imports torch and
numpy, never jax.

    from llckbdm_tpu_torch import (
        sample_signal, LineList, line_list_from_np, line_list_to_np,
        kbdm_fit, kbdm_sweep, KbdmConfig,
        llc_kbdm_fit, LlcKbdmConfig,
        refine_lines, refined_to_np, RefineConfig,
    )
"""

from .signals import (LineList, line_list_from_np, line_list_to_np,
                      sample_signal)
from .solver.kbdm import KbdmConfig, kbdm_fit, kbdm_sweep
from .solver.refine import (RefineConfig, RefinedLines, refine_lines,
                            refined_to_np)
from .pipeline.llckbdm import (ClusterStats, LlcKbdmConfig, llc_kbdm,
                               llc_kbdm_fit)
from . import parallel

__version__ = "0.1.0"

__all__ = [
    "LineList", "line_list_from_np", "line_list_to_np", "sample_signal",
    "KbdmConfig", "kbdm_fit", "kbdm_sweep",
    "ClusterStats", "LlcKbdmConfig", "llc_kbdm", "llc_kbdm_fit",
    "RefineConfig", "RefinedLines", "refine_lines", "refined_to_np",
    "parallel",
    "__version__",
]
