"""The reference-compatible ``SpatialImageAnalysis`` facade (2D, 3D, 3DS),
its wall/morphology helpers and label-image utilities."""
from tissue_analysis_tpu_torch.analysis.base import (  # noqa: F401
    DICT,
    LIST,
    NPLIST,
    AbstractSpatialImageAnalysis,
    AnalysisConfig,
    resolve_engine,
)
from tissue_analysis_tpu_torch.analysis.dimensional import (  # noqa: F401
    SpatialImageAnalysis,
    SpatialImageAnalysis2D,
    SpatialImageAnalysis3D,
    SpatialImageAnalysis3DS,
)
from tissue_analysis_tpu_torch.analysis.helpers import (  # noqa: F401
    dilation,
    dilation_by,
    distance,
    hollow_out_cells,
    sort_boundingbox,
    wall,
)
from tissue_analysis_tpu_torch.analysis.misc import (  # noqa: F401
    labels_in_image,
    load_labels,
    relabel_image,
    remove_cells,
    save_labels,
)
