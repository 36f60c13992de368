"""z-slab sharding over several devices (``sharded``) and its equality check
(``python -m tissue_analysis_tpu_torch.parallel.dryrun N``)."""

from tissue_analysis_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    analyze_sharded,
    analyze_sharded_blocked,
    analyze_sharded_chunked,
    analyze_sharded_pallas,
    make_mesh,
    sharded_pipeline,
)
