from .sharedbottom import SharedBottom
from .esmm import ESMM
from .mmoe import MMOE
from .ple import PLE
