"""segan_pytorch_tpu_torch — the PyTorch/CUDA port of segan_pytorch_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout (``ops``, ``models``, ``utils``,
``data``, ``parallel``) so each module's counterpart is easy to find. It imports
``torch``, numpy and scipy only: never ``jax`` and never ``segan_pytorch_tpu``,
whose package import pulls jax in. The few framework-neutral pieces it needs
(config, wav I/O, pre-/de-emphasis) are copies, each pinned to its original by a
test in ``tests/test_torch_config.py``.

Layout: public functions take the JAX package's channels-last ``(B, T, C)``
arrays; inside the network every tensor is torch's ``(B, C, T)``, and parameters
carry the upstream torch state_dict names and layouts, so a reference-format
``.ckpt`` loads with ``load_state_dict(strict=True)``.

Submodules are imported on use; importing this package loads nothing else.
"""

__version__ = "0.3.0"
