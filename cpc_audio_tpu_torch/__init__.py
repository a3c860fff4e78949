"""PyTorch + CUDA port of cpc_audio_tpu for NVIDIA Hopper GPUs.

The JAX package ``cpc_audio_tpu`` is the reference.  This package mirrors
its layout (``models/``, ``criterion/``, ``ops/``, ``parallel/``,
``data/``, ``utils/``, ``config.py``, ``feature_loader.py``, ``train.py``)
and imports ``torch``, never ``jax`` and nothing of ``cpc_audio_tpu``.
The pretraining step for every ``--arMode``, its CLI and the eval path
are ported.  The kernels under ``csrc/`` are built with ``nvcc`` on first
use (``ops/_build.py``).
"""
