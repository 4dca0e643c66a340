"""Speech-quality metrics, copies of ``segan_pytorch_tpu/metrics`` (``composite``,
``pesq``, ``pesq_native``, ``perceptual``, ``stoi``, and ``f0`` over ``data/aco.py``).
Numpy, scipy and ctypes only: the evaluation pool's workers import this package and
nothing else of the port but ``data/aco.py`` (``data/__init__.py`` is empty)."""
from .composite import (  # noqa: F401
    SSNR,
    wss,
    llr,
    lpcoeff,
    CompositeEval,
    eval_composite,
    composite_helper,
)
from .pesq import PESQ  # noqa: F401
from .stoi import stoi  # noqa: F401
from .f0 import F0Evaluator, KLD, compute_MAE, compute_accuracy  # noqa: F401
