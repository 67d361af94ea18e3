from .fc_caption import FCCaptionModel, FCModelOptions, build_spec
from .params import Leaf, ParamSpec, theta_from_numpy, theta_to_numpy

__all__ = ["FCCaptionModel", "FCModelOptions", "build_spec", "Leaf",
           "ParamSpec", "theta_from_numpy", "theta_to_numpy"]
