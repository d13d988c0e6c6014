"""PyTorch/CUDA port of ``rnad_tpu`` (R-NaD on random matrix-tree games).

The JAX package ``rnad_tpu`` is the reference; every module here keeps its
counterpart's name and layout.  The port imports ``torch`` and numpy only,
never ``jax``, ``flax``, ``optax`` or ``rnad_tpu``.  Its two hot operations
are hand-written CUDA kernels for Hopper (``csrc/``, built at first use by
``ops/_build.py``); each has a plain PyTorch twin that runs for CPU tensors.

Importing this package imports nothing heavy: pull in the modules you use,
e.g. ``from rnad_tpu_torch.learn import rnad``.
"""
