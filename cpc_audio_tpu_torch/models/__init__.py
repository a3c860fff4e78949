from .ar import CPCAR, NoAr
from .cpc import CPCModel, build_model, get_ar
from .encoder import CPCEncoder
from .norms import ChannelNorm
from .transformer import TransformerAR

__all__ = ["CPCAR", "CPCEncoder", "CPCModel", "ChannelNorm", "NoAr",
           "TransformerAR", "build_model", "get_ar"]
