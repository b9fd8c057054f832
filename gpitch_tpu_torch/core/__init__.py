from .params import Param, load_raw, named_params  # noqa: F401
from .transforms import FillTriangular, Identity, Logistic, Positive  # noqa: F401
