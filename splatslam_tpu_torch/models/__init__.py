from .droid_net import DroidNet, compute_dtype, normalize_images  # noqa: F401
from .weights import load_droid_params  # noqa: F401
