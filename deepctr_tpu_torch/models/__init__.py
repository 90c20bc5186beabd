from .basemodel import BaseModel
from .deepfm import DeepFM
