"""PyTorch/CUDA port of the ``repro`` package.

Module names mirror ``src/repro/``: ``repro_torch/X.py`` is the counterpart
of ``repro/X.py`` and is tested against it.  The package imports ``torch``
and numpy only — never JAX and nothing of ``repro`` — and its kernels
(attention, the Mamba2 SSD scan) are hand-written CUDA for Hopper
(``csrc/``), built at first use.
"""
