from .ar import CPCAR, NoAr
from .cpc import CPCModel, ConcatenatedModel, build_model, get_ar
from .encoder import CPCEncoder
from .norms import ChannelNorm
from .transformer import TransformerAR

__all__ = ["CPCAR", "CPCEncoder", "CPCModel", "ChannelNorm",
           "ConcatenatedModel", "NoAr", "TransformerAR", "build_model",
           "get_ar"]
