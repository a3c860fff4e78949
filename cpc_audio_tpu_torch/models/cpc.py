"""CPCModel: encoder + autoregressive context network
(cpc_audio_tpu/models/cpc.py).

``model(batch, label, hidden, train, seed) -> (c, z, label, hidden_out)``
with channels-last activations, as in the JAX package.  Parameters are
float32; activations run in ``config.compute_dtype``, but where the
encoder gives float32 (``models/encoder.encoding_dtype``).  The encoder
is any ``--encoder_type`` with any ``--normMode``; the AR any of the JAX
package's ``--arMode``s: LSTM (K1 kernels), GRU (K4), RNN (a plain loop),
transformer (K5 attention) or no_ar, flipped in time under ``--cpc_mode
reverse``.  Only the transformer AR drops in training, from ``seed``;
batchNorm's running statistics move in training (``train=True``);
gradients flow through cuDNN convs and the AR's kernels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .._common import compute_dtype, fused_layer_switches
from ..config import CPCConfig
from ..ops import causal_attention, gru, lstm
from .ar import CPCAR, NoAr
from .encoder import encoding_dtype, get_encoder
from .transformer import TransformerAR


def check_kernels(config: CPCConfig) -> None:
    """Raise ValueError, naming the flag and the limit, for a config whose
    AR the port's kernels cannot run (the gates of K1, K4 and K5), before
    any weight or step exists: ``--hiddenGar`` past 8192 with ``--arMode
    LSTM`` or ``GRU`` (K1, K4: ``ops/lstm.py`` ``MAX_H``), and with
    ``--arMode transformer`` ``--hiddenEncoder`` past 4096 (K5's 8 heads
    past dk 512, or in bf16 at a dk that is no multiple of 8) or
    ``--sizeWindow`` past 655519 (K5 past S 4096 frames,
    ``ops/causal_attention.py`` ``MAX_S``).  A refused shape is run by no
    plain version in its place.  Under ``CPC_PALLAS_CONV=1`` the encoder
    fuses the layers K7 takes and leaves the rest to cuDNN, as the JAX
    package leaves the layers its gate refuses to XLA
    (:meth:`CPCEncoder.fused_layers`; at ``--hiddenEncoder 512`` neither
    fuses any).  Runs without a card."""
    problems = []
    H, D, W = config.hiddenGar, config.hiddenEncoder, config.sizeWindow
    if config.arMode in ("LSTM", "GRU"):
        why = (lstm if config.arMode == "LSTM" else gru).supported(H)
        if why:
            problems.append(f"--hiddenGar {H} (--arMode {config.arMode}): "
                            f"{why}")
    elif config.arMode == "transformer":
        nheads = 8          # TransformerLayer's, as in the JAX package
        if D % nheads:
            problems.append(f"--hiddenEncoder {D} (--arMode transformer): "
                            f"its {nheads} heads need a multiple of "
                            f"{nheads}")
        else:
            dtype = encoding_dtype(config)
            why_dk = causal_attention.supported(1, D // nheads, dtype)
            why_s = causal_attention.supported(W // 160, D // nheads, dtype)
            if why_dk:
                problems.append(f"--hiddenEncoder {D} (--arMode transformer, "
                                f"K5): {why_dk}")
            elif why_s:
                problems.append(f"--sizeWindow {W} (--arMode transformer, "
                                f"K5, S = {W // 160} frames): {why_s}")
    if problems:
        raise ValueError("the port's kernels refuse this config: " +
                         "; ".join(problems))


def get_ar(config: CPCConfig, generator: Optional[torch.Generator] = None
           ) -> nn.Module:
    """Flag -> AR (cpc_audio_tpu/models/cpc.py:31-42); the recurrent ARs
    run flipped in time under ``--cpc_mode reverse``."""
    mode = config.arMode
    if mode == "transformer":
        # one transformer layer whatever nLevelsGRU says (cpc.py:35-38)
        return TransformerAR(config.hiddenEncoder, 1,
                             config.sizeWindow // 160, config.abspos,
                             generator=generator)
    if mode == "no_ar":
        return NoAr()
    return CPCAR(config.hiddenEncoder, config.hiddenGar, config.nLevelsGRU,
                 mode, generator, reverse=config.cpc_mode == "reverse")


class CPCModel(nn.Module):
    """Encoder + AR with an explicit hidden carry."""

    def __init__(self, config: CPCConfig,
                 generator: Optional[torch.Generator] = None,
                 fused_conv: bool = False):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config.compute_dtype)
        self.gEncoder = get_encoder(config, generator, fused_conv)
        self.gAR = get_ar(config, generator)

    def zero_state(self, batch: int, device) -> object:
        """The AR's zero hidden state in the compute dtype: a (layers, B,
        H) tensor (GRU, RNN), an (h, c) pair of them (LSTM), or None
        (transformer, no_ar)."""
        return self.gAR.zero_state(batch, self.dtype, torch.device(device))

    def forward(self, batch: torch.Tensor, label=None, hidden=None,
                train: bool = False, seed: Optional[torch.Tensor] = None):
        z = self.gEncoder(batch, self.dtype, train)      # (B, S, C)
        c, hidden_out = self.gAR(z, hidden, train, seed)
        return c, z, label, hidden_out


class ConcatenatedModel(nn.Module):
    """Several CPC models side by side (cpc_audio_tpu/models/cpc.py
    :85-117): each runs on the same batch, their contexts and encodings
    are concatenated on the channel axis, and the hidden state is a list
    with one entry per model.  Built by ``feature_loader.load_model`` for
    several checkpoints; the models are ``model0``, ``model1``, ... as in
    the JAX package's tree."""

    def __init__(self, models: Sequence[CPCModel]):
        super().__init__()
        self.n_models = len(models)
        for i, m in enumerate(models):
            setattr(self, f"model{i}", m)

    @property
    def models(self) -> List[CPCModel]:
        return [getattr(self, f"model{i}") for i in range(self.n_models)]

    def zero_state(self, batch: int, device) -> list:
        return [m.zero_state(batch, device) for m in self.models]

    def forward(self, batch: torch.Tensor, label=None, hidden=None,
                train: bool = False, seed: Optional[torch.Tensor] = None):
        if hidden is None:
            hidden = [None] * self.n_models
        feats, encs, hids = [], [], []
        for m, h in zip(self.models, hidden):
            c, z, label, h_out = m(batch, label, h, train, seed)
            feats.append(c)
            encs.append(z)
            hids.append(h_out)
        return (torch.cat(feats, dim=2), torch.cat(encs, dim=2), label,
                hids)


def build_model(config: CPCConfig,
                generator: Optional[torch.Generator] = None) -> CPCModel:
    """Build a CPCModel with weights drawn from ``generator``.  no_ar and
    transformer emit hiddenEncoder-wide contexts, so they force hiddenGar
    == hiddenEncoder (cpc.py:120-125); callers size the criterion from the
    returned ``model.config``.  The encoder fuses its layers under
    ``CPC_PALLAS_CONV=1``.  A config the kernels refuse raises first
    (:func:`check_kernels`)."""
    if config.arMode in ("no_ar", "transformer"):
        config = config.replace(hiddenGar=config.hiddenEncoder)
    check_kernels(config)
    return CPCModel(config, generator, fused_layer_switches()[0])
