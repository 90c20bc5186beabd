from .activation import activation_layer
from .core import DNN, PredictionLayer
from .interaction import FM
from .utils import concat_fun
