from .activation import Dice, PReLU, activation_layer
from .core import DNN, LocalActivationUnit, PredictionLayer
from .interaction import (FM, BiInteractionPooling, SENETLayer,
                          BilinearInteraction, CIN, AFMLayer,
                          InteractingLayer, CrossNet, CrossNetMix,
                          InnerProductLayer, OutterProductLayer)
from .sequence import (AGRUCell, AUGRUCell, AttentionSequencePoolingLayer,
                       DynamicGRU, MaskedGRU, SequencePoolingLayer,
                       masked_pooling)
from .utils import concat_fun
