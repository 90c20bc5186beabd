from .activation import Dice, PReLU, activation_layer
from .core import DNN, Conv2dSame, LocalActivationUnit, PredictionLayer
from .interaction import (FM, BiInteractionPooling, SENETLayer,
                          BilinearInteraction, CIN, AFMLayer,
                          InteractingLayer, CrossNet, CrossNetMix,
                          InnerProductLayer, OutterProductLayer, ConvLayer,
                          LogTransformLayer)
from .sequence import (AGRUCell, AUGRUCell, AttentionSequencePoolingLayer,
                       DynamicGRU, KMaxPooling, MaskedGRU,
                       SequencePoolingLayer, masked_pooling)
from .utils import concat_fun
