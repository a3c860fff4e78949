"""Typed configuration of the port: its own copy of
``cpc_audio_tpu/config.py``.

Same classes, field names and defaults as the JAX package's, so a
``checkpoint_args.json`` written by either package loads in the other;
the tests hold the two copies field by field.  A dataclass replaces the
original CPC_audio argparse namespace (cpc_default_config.py:13-91), and
:func:`add_cpc_args` re-exposes every one of its flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class CPCConfig:
    """Architecture / optimization surface of the CPC model.

    Field names intentionally mirror the reference CLI flags
    (cpc_default_config.py:19-89) for sidecar-JSON parity.
    """

    # Architecture
    hiddenEncoder: int = 256
    hiddenGar: int = 256
    nPredicts: int = 12
    negativeSamplingExt: int = 128
    sizeWindow: int = 20480
    samplingType: str = "samespeaker"   # samespeaker|uniform|samesequence|sequential
    nLevelsPhone: int = 1
    cpc_mode: Optional[str] = None      # None | 'reverse' | 'none'
    encoder_type: str = "cpc"           # cpc | mfcc | lfb
    normMode: str = "layerNorm"         # instanceNorm | ID | layerNorm | batchNorm
    onEncoder: bool = False
    speakerEmbedding: int = 0
    arMode: str = "LSTM"                # GRU | LSTM | RNN | no_ar | transformer
    nLevelsGRU: int = 1
    rnnMode: str = "transformer"        # prediction-head type
    dropout: bool = False
    abspos: bool = False

    # Optimization
    learningRate: float = 2e-4
    schedulerStep: int = -1
    schedulerRamp: Optional[int] = None
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    nEpoch: int = 200
    random_seed: Optional[int] = None

    # Extensions of the JAX package (absent from the original CPC_audio;
    # the defaults keep its semantics).
    compute_dtype: str = "float32"      # float32 | bfloat16 : activation dtype
    negative_sampling_scope: str = "device"  # device (reference per-shard) | global
    negativeSamplingMode: str = "auto"  # auto | exact (reference) | stratified | rolled
    stopGradNegatives: bool = False      # fast objective variant (see docs)

    def replace(self, **kw) -> "CPCConfig":
        return dataclasses.replace(self, **kw)

    # ---- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict, strict: bool = False) -> "CPCConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if strict and unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items() if k in names})

    # Derived quantities -------------------------------------------------
    @property
    def n_frames(self) -> int:
        """Latent frames per window (reference: sizeWindow // 160)."""
        return self.sizeWindow // 160

    @property
    def window_size(self) -> int:
        """InfoNCE context window = n_frames - nPredicts (criterion.py:232)."""
        return self.n_frames - self.nPredicts


def get_default_cpc_config() -> CPCConfig:
    """Parity with cpc_default_config.get_default_cpc_config (:8-10)."""
    return CPCConfig()


def add_cpc_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Reference-flag-compatible CLI group (cpc_default_config.py:13-91)."""
    g = parser.add_argument_group("Architecture configuration")
    d = CPCConfig()
    g.add_argument("--hiddenEncoder", type=int, default=d.hiddenEncoder)
    g.add_argument("--hiddenGar", type=int, default=d.hiddenGar)
    g.add_argument("--nPredicts", type=int, default=d.nPredicts)
    g.add_argument("--negativeSamplingExt", type=int, default=d.negativeSamplingExt)
    g.add_argument("--learningRate", type=float, default=d.learningRate)
    g.add_argument("--schedulerStep", type=int, default=d.schedulerStep)
    g.add_argument("--schedulerRamp", type=int, default=d.schedulerRamp)
    g.add_argument("--beta1", type=float, default=d.beta1)
    g.add_argument("--beta2", type=float, default=d.beta2)
    g.add_argument("--epsilon", type=float, default=d.epsilon)
    g.add_argument("--sizeWindow", type=int, default=d.sizeWindow)
    g.add_argument("--nEpoch", type=int, default=d.nEpoch)
    g.add_argument("--samplingType", type=str, default=d.samplingType,
                   choices=["samespeaker", "uniform", "samesequence", "sequential"])
    g.add_argument("--nLevelsPhone", type=int, default=d.nLevelsPhone)
    g.add_argument("--cpc_mode", type=str, default=d.cpc_mode,
                   choices=["reverse", "none"])
    g.add_argument("--encoder_type", type=str, default=d.encoder_type,
                   choices=["cpc", "mfcc", "lfb"])
    g.add_argument("--normMode", type=str, default=d.normMode,
                   choices=["instanceNorm", "ID", "layerNorm", "batchNorm"])
    g.add_argument("--onEncoder", action="store_true")
    g.add_argument("--random_seed", type=int, default=d.random_seed)
    g.add_argument("--speakerEmbedding", type=int, default=d.speakerEmbedding)
    g.add_argument("--arMode", default=d.arMode,
                   choices=["GRU", "LSTM", "RNN", "no_ar", "transformer"])
    g.add_argument("--nLevelsGRU", type=int, default=d.nLevelsGRU)
    g.add_argument("--rnnMode", type=str, default=d.rnnMode,
                   choices=["transformer", "RNN", "LSTM", "linear",
                            "ffd", "conv4", "conv8", "conv12"])
    g.add_argument("--dropout", action="store_true")
    g.add_argument("--abspos", action="store_true")
    # extensions of the JAX package
    g.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=["float32", "bfloat16"])
    g.add_argument("--negative_sampling_scope", type=str,
                   default=d.negative_sampling_scope,
                   choices=["device", "global"])
    g.add_argument("--stopGradNegatives", action="store_true",
                   help="No gradients through negative samples (2x faster "
                        "steps; changes the objective — see PERFORMANCE.md)")
    g.add_argument("--negativeSamplingMode", type=str,
                   default=d.negativeSamplingMode,
                   choices=["auto", "exact", "rolled", "stratified"],
                   help="auto (default): stratified when batch*seq and "
                        "negativeSamplingExt are powers of two (and "
                        "scope is device), exact otherwise; "
                        "stratified: permutation-stratified negatives — "
                        "same per-window marginals, no duplicate "
                        "negatives per anchor, fused scatter-free "
                        "scoring (~1.8x faster steps, validated "
                        "metric-neutral-or-better at fixture scale — "
                        "docs/PERFORMANCE.md round 4); "
                        "exact: the reference's iid sampler; "
                        "rolled: DEPRECATED test hook — measured both "
                        "slower than exact AND learning-degrading "
                        "(docs/PERFORMANCE.md round 3); no known use")
    return parser


def config_from_namespace(ns: argparse.Namespace) -> CPCConfig:
    return CPCConfig.from_dict(vars(ns))


@dataclass
class TrainConfig:
    """Run-level settings (reference train.py:390-488 CLI groups)."""

    pathDB: Optional[str] = None
    file_extension: str = ".flac"
    pathTrain: Optional[str] = None
    pathVal: Optional[str] = None
    n_process_loader: int = 8
    ignore_cache: bool = False
    max_size_loaded: int = 4_000_000_000

    supervised: bool = False
    pathPhone: Optional[str] = None
    CTC: bool = False

    pathCheckpoint: Optional[str] = None
    logging_step: int = 1000
    save_step: int = 5
    load: Optional[List[str]] = None
    loadCriterion: bool = False
    restart: bool = False

    batchSizeGPU: int = 8      # per-device batch (reference name kept)
    nGPU: int = -1             # number of devices; -1 = all
    debug: bool = False

    # extensions of the JAX package
    profile_dir: Optional[str] = None   # profiler trace output dir
    distributed: bool = False           # initialize multi-host runtime
    export_torch: bool = False          # also save reference-format .torch.pt

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
