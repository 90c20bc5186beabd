from .activation import Dice, PReLU, activation_layer
from .core import DNN, LocalActivationUnit, PredictionLayer
from .interaction import CIN, FM
from .sequence import (AGRUCell, AUGRUCell, AttentionSequencePoolingLayer,
                       DynamicGRU, MaskedGRU, SequencePoolingLayer,
                       masked_pooling)
from .utils import concat_fun
