from .fc_caption import FCCaptionModel, FCModelOptions, build_spec
from .mnist import MnistModel, MnistModelOptions
from .params import Leaf, ParamSpec, theta_from_numpy, theta_to_numpy

__all__ = ["FCCaptionModel", "FCModelOptions", "MnistModel",
           "MnistModelOptions", "build_spec", "Leaf",
           "ParamSpec", "theta_from_numpy", "theta_to_numpy"]
