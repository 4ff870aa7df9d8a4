"""PyTorch/CUDA port of ``scgib_tpu``: S-CGIB pretraining and fine-tuning on
NVIDIA Hopper.

The JAX package ``scgib_tpu`` is the reference; this package mirrors its
module layout and names and imports nothing of it (nor of JAX).  Hand-written
CUDA kernels for the banded adjacency products and the graph-transformer
attention live in ``csrc/`` and are built at first use
(``ops/kernels/build.py``; wrappers in ``ops/kernels/banded.py`` and
``ops/kernels/gt_flash.py``).  ``cli.py`` holds the ``pretrain``,
``finetune``, ``eval`` and ``adapt`` verbs; their checkpoints and autosaves
are the JAX package's format (``train/checkpoint.py``).
"""
