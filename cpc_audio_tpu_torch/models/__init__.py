from .ar import CPCAR
from .cpc import CPCModel, build_model
from .encoder import CPCEncoder
from .norms import ChannelNorm

__all__ = ["CPCAR", "CPCEncoder", "CPCModel", "ChannelNorm", "build_model"]
