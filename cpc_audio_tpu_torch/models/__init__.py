from .ar import CPCAR, BiDIRAR, BiDIRARTangled, NoAr
from .cpc import CPCModel, ConcatenatedModel, build_model, get_ar
from .encoder import CPCEncoder, LFBEncoder, MFCCEncoder, get_encoder
from .norms import BatchNorm, ChannelNorm, Identity, InstanceNorm
from .transformer import TransformerAR

__all__ = ["BatchNorm", "BiDIRAR", "BiDIRARTangled", "CPCAR", "CPCEncoder",
           "CPCModel", "ChannelNorm", "ConcatenatedModel", "Identity",
           "InstanceNorm", "LFBEncoder", "MFCCEncoder", "NoAr",
           "TransformerAR", "build_model", "get_ar", "get_encoder"]
