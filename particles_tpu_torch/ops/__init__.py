"""Hand-written CUDA kernels for the hot particle operations, each with its
plain PyTorch version beside it (counterpart of ``particles_tpu.ops``).

A wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its launches
in the counter ``launch.<kernel>`` of :mod:`particles_tpu_torch.tracing`,
``<kernel>`` one of :data:`KERNELS`:

=====  ===========================  =====================  ===============
ID     Wrapper                      ``<kernel>``           What
=====  ===========================  =====================  ===============
B1     ``systematic_z_fused``       ``systematic_z``       systematic
                                                           z-form
B2     ``repeat_cols``              ``repeat_by_z``        move by z
B3     ``normalised_cumsum_exact``  ``normalised_cumsum``  monotone
                                                           normalised
                                                           cumsum
B4     ``repeat_cols_su``           ``repeat_by_su``       move by the
                                                           inverse CDF
B5     ``merge_rank_counts``        ``merge_rank_counts``  sorted-merge
                                                           rank count
B6     ``running_max``              ``running_max``        inclusive
                                                           running max
=====  ===========================  =====================  ===============
"""

from particles_tpu_torch.ops.cummax_kernel import (  # noqa: F401
    running_max,
    running_max_geometry,
    running_max_plain,
)
from particles_tpu_torch.ops.merge_rank_kernel import (  # noqa: F401
    MERGE_RANK_TILE,
    MERGE_RANK_WINDOW,
    merge_rank_counts,
    merge_rank_counts_plain,
)
from particles_tpu_torch.ops.repeat_kernel import (  # noqa: F401
    GUIDE_SHIFT,
    MAX_PAYLOADS,
    MERGE_TILE,
    ancestors_by_su,
    ancestors_by_z,
    guide_buckets,
    repeat_by_z,
    repeat_cols,
    repeat_cols_plain,
    repeat_cols_su,
    repeat_cols_su_plain,
    serve_by_z,
)
from particles_tpu_torch.ops.z_kernel import (  # noqa: F401
    normalised_cumsum_exact,
    normalised_cumsum_geometry,
    normalised_cumsum_plain,
    systematic_z_fused,
    systematic_z_geometry,
    systematic_z_plain,
)

# the kernels, each counted as tracing's ``launch.<kernel>``
KERNELS = ("systematic_z", "repeat_by_z", "normalised_cumsum", "repeat_by_su",
           "merge_rank_counts", "running_max")
