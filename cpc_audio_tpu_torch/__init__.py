"""PyTorch + CUDA port of cpc_audio_tpu for NVIDIA Hopper GPUs.

The JAX package ``cpc_audio_tpu`` is the reference.  This package mirrors
its layout (``models/``, ``criterion/``, ``ops/``, ``parallel/``,
``feature_loader.py``) and imports ``torch``, never ``jax``.  The forward
(eval) path is ported; the training path is not yet.  The kernels under
``csrc/`` are built with ``nvcc`` on first use (``ops/_build.py``).
"""
