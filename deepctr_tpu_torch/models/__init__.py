from .basemodel import BaseModel
from .deepfm import DeepFM
from .din import DIN
from .dien import DIEN
from .xdeepfm import xDeepFM
