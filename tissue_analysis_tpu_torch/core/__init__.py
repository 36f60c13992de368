from tissue_analysis_tpu_torch.core.spatial_image import SpatialImage, imread, imsave  # noqa: F401
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: F401
