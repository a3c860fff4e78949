"""The waveform encoders (cpc_audio_tpu/models/encoder.py), picked by
``--encoder_type`` in :func:`get_encoder`: CPCEncoder (``cpc``, five
strided convs, each with its ``--normMode`` norm and ReLU, 160x
downsampling, :153-207), MFCCEncoder (``mfcc``, :243-279) and LFBEncoder
(``lfb``, :282-319).  Every one gives ``sizeWindow // 160`` frames at a
multiple of 160 samples.

By default the convs are plain ``F.conv1d`` (the JAX package leaves them to
XLA on its default path) with activations channels-first ``(B, C, T)``.
With ``fused_conv`` (``CPC_PALLAS_CONV=1`` through ``build_model``), each
layer that :func:`~cpc_audio_tpu_torch.ops.conv_ln.fused_conv_supported`
accepts runs conv + bias + ChannelNorm + ReLU as the K7 kernel
(``ops/conv_ln.py``) channels-last, as the JAX package's fused path does:
at the default config layers 1-4, not the waveform layer 0 (C_in = 1), which
is transposed once to ``(B, T, C)`` after it.  The parameters are the same
under both paths; K7 runs only under layerNorm, as encoder.py:186-187.
The output is the JAX package's channels-last ``(B, T // 160, C)``, in
the compute dtype but under batchNorm, whose flax module gives float32
(models/norms.py).

MFCC and LFB compute in float32 whatever ``--compute_dtype`` says, as the
JAX encoders do (they never cast to the config's dtype); the AR then
follows their dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._common import compute_dtype, uniform
from ..config import CPCConfig
from ..ops.conv_ln import conv_ln_relu, fused_conv_supported, out_frames
from .norms import make_norm_layer

CONV_KERNELS = (10, 8, 4, 4, 4)
CONV_STRIDES = (5, 4, 2, 2, 2)
CONV_PADS = (3, 2, 1, 1, 1)


class _Conv(nn.Module):
    """Conv1d parameters in torch's (out, in, k) layout, torch init."""

    def __init__(self, c_in: int, c_out: int, k: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        bound = 1.0 / math.sqrt(c_in * k)
        self.weight = uniform((c_out, c_in, k), bound, generator)
        self.bias = uniform((c_out,), bound, generator)


class CPCEncoder(nn.Module):
    """Input (B, 1, T) or (B, T) waveform; output (B, T // 160, C)."""

    def __init__(self, size_hidden: int = 256,
                 generator: Optional[torch.Generator] = None,
                 fused_conv: bool = False, norm_mode: str = "layerNorm"):
        super().__init__()
        self.size_hidden = size_hidden
        self.fused_conv = fused_conv and norm_mode == "layerNorm"
        c_in = 1
        for i, k in enumerate(CONV_KERNELS):
            setattr(self, f"conv{i}", _Conv(c_in, size_hidden, k, generator))
            setattr(self, f"norm{i}", make_norm_layer(norm_mode,
                                                      size_hidden))
            c_in = size_hidden

    def fused_layers(self, n_samples: int) -> Tuple[int, ...]:
        """The layers that run as the K7 kernel for an n_samples input."""
        if not self.fused_conv:
            return ()
        fused, T = [], n_samples
        for i, (k, s, p) in enumerate(zip(CONV_KERNELS, CONV_STRIDES,
                                          CONV_PADS)):
            c_out, c_in, _ = getattr(self, f"conv{i}").weight.shape
            if fused_conv_supported(c_in, c_out, k, s, p, T):
                fused.append(i)
            T = out_frames(T, k, s, p)
        return tuple(fused)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                train: bool = False) -> torch.Tensor:
        if x.dim() == 2:
            x = x[:, None, :]
        x = x.to(dtype)
        fused = self.fused_layers(x.shape[-1])
        last = False                      # layout: channels-last or -first
        for i, (k, s, p) in enumerate(zip(CONV_KERNELS, CONV_STRIDES,
                                          CONV_PADS)):
            conv, norm = getattr(self, f"conv{i}"), getattr(self, f"norm{i}")
            if i in fused:
                if not last:
                    x, last = x.transpose(1, 2).contiguous(), True
                c_out, c_in, _ = conv.weight.shape
                w = conv.weight.to(dtype).permute(2, 1, 0).reshape(
                    k * c_in, c_out).contiguous()
                x = conv_ln_relu(x, w, conv.bias, norm.weight, norm.bias, s,
                                 k, p, norm.epsilon)
                continue
            if last:
                x, last = x.transpose(1, 2), False
            x = F.conv1d(x.to(dtype), conv.weight.to(dtype),
                         conv.bias.to(dtype), stride=s, padding=p)
            x = torch.relu(norm(x, train))
        return x if last else x.transpose(1, 2).contiguous()


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int) -> np.ndarray:
    """HTK-style triangular mel filterbank from 0 to 8 kHz at 16 kHz,
    (n_freqs, n_mels) (encoder.py:220-232)."""
    all_freqs = np.linspace(0, 8000, n_freqs)
    m_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, (n_mels, n_mfcc) (encoder.py:235-240)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :]) * 2.0
    dct[:, 0] *= 1.0 / math.sqrt(2.0)
    dct *= math.sqrt(1.0 / (2.0 * n_mels))
    return dct.astype(np.float32)


def _hann(n: int) -> torch.Tensor:
    """numpy's periodic Hann window of n taps (``np.hanning(n + 1)[:-1]``),
    float32, as the JAX encoders build it."""
    return torch.from_numpy(np.hanning(n + 1)[:-1].astype(np.float32))


def _waveform(x: torch.Tensor) -> torch.Tensor:
    """(B, 1, T) or (B, T) -> (B, T) float32."""
    return (x.reshape(x.shape[0], -1) if x.dim() == 3 else x).float()


_N_FFT = 321       # MFCC frame: hop and reflect padding are n_fft // 2 = 160


class MFCCEncoder(nn.Module):
    """The MFCC front end (encoder.py:243-279), torchaudio's MFCC: reflect
    padding of n_fft // 2, Hann frames of n_fft 321 at hop 160, the power
    spectrum through ``torch.fft.rfft``, a mel filterbank of max(128, C)
    bands, dB with top_db 80 (over each window), then the orthonormal
    DCT-II to C coefficients.  No parameters; float32 (B, frames, C)."""

    def __init__(self, dim_encoded: int):
        super().__init__()
        self.dim_encoded = dim_encoded
        n_mels = max(128, dim_encoded)
        self.register_buffer("window", _hann(_N_FFT), persistent=False)
        self.register_buffer("fb", torch.from_numpy(mel_filterbank(
            _N_FFT // 2 + 1, n_mels)), persistent=False)
        self.register_buffer("dct", torch.from_numpy(dct_matrix(
            dim_encoded, n_mels)), persistent=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                train: bool = False) -> torch.Tensor:
        x = _waveform(x)
        hop = _N_FFT // 2
        xp = F.pad(x[:, None], (hop, hop), mode="reflect")[:, 0]
        frames = xp.unfold(1, _N_FFT, hop) * self.window       # (B, F, n)
        spec = torch.fft.rfft(frames, dim=-1).abs() ** 2
        db = 10.0 * torch.log10(torch.clamp_min(spec @ self.fb, 1e-10))
        top = db.amax(dim=(1, 2), keepdim=True) - 80.0
        return torch.maximum(db, top) @ self.dct


class LFBEncoder(nn.Module):
    """Learned filter banks (encoder.py:282-319): a conv of 400 taps to 2C
    channels (``conv``, torch's layout and init), the squared magnitude of
    each channel pair (2c, 2c + 1), a depthwise Hann smoothing of 400 taps
    at stride 160 with 350 of padding each side, log(1 + |x|), then each
    channel normalised over time (biased variance, eps 1e-5).  Float32
    (B, frames, C)."""

    def __init__(self, dim_encoded: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim_encoded = dim_encoded
        self.conv = _Conv(1, 2 * dim_encoded, 400, generator)
        self.register_buffer("window", _hann(400).reshape(1, 1, 400),
                             persistent=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                train: bool = False) -> torch.Tensor:
        x = _waveform(x)
        B, C = x.shape[0], self.dim_encoded
        y = F.conv1d(x[:, None], self.conv.weight, self.conv.bias)  # (B,2C,L)
        y = y.reshape(B, C, 2, -1)
        y = y[:, :, 0] ** 2 + y[:, :, 1] ** 2                       # (B, C, L)
        y = F.conv1d(y.reshape(B * C, 1, -1), self.window, stride=160,
                     padding=350).reshape(B, C, -1)
        y = torch.log1p(y.abs()).transpose(1, 2)                    # (B, F, C)
        mean = y.mean(dim=1, keepdim=True)
        var = y.var(dim=1, keepdim=True, correction=0)
        return (y - mean) * torch.rsqrt(var + 1e-5)


def get_encoder(config: CPCConfig,
                generator: Optional[torch.Generator] = None,
                fused_conv: bool = False) -> nn.Module:
    """``--encoder_type`` -> encoder (encoder.py:322-329)."""
    if config.encoder_type == "mfcc":
        return MFCCEncoder(config.hiddenEncoder)
    if config.encoder_type == "lfb":
        return LFBEncoder(config.hiddenEncoder, generator)
    return CPCEncoder(config.hiddenEncoder, generator, fused_conv,
                      config.normMode)


def encoding_dtype(config: CPCConfig) -> torch.dtype:
    """The dtype of the encoder's output z, which the AR and the heads
    follow: float32 for MFCC and LFB, and under batchNorm (flax infers it
    from the float32 parameters), else the compute dtype."""
    if config.encoder_type in ("mfcc", "lfb") or \
            config.normMode == "batchNorm":
        return torch.float32
    return compute_dtype(config.compute_dtype)
