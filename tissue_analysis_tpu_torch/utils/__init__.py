from tissue_analysis_tpu_torch.utils.timing import (  # noqa: F401
    Timings,
    collect,
    stage,
)
