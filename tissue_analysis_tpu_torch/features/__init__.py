from tissue_analysis_tpu_torch.features.table import FeatureTable  # noqa: F401
from tissue_analysis_tpu_torch.features import finalize  # noqa: F401
