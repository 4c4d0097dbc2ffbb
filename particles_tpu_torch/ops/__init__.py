"""Hand-written CUDA kernels for the hot particle operations, each with its
plain PyTorch version beside it (counterpart of ``particles_tpu.ops``).

A wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its launches
in ``<wrapper>.launches``.
"""

from particles_tpu_torch.ops.repeat_kernel import (  # noqa: F401
    MAX_PAYLOADS,
    ancestors_by_z,
    repeat_by_z,
    repeat_cols,
    repeat_cols_plain,
    serve_by_z,
)
from particles_tpu_torch.ops.z_kernel import (  # noqa: F401
    systematic_z_fused,
    systematic_z_plain,
)
