"""Speech-quality metrics of the validation set, copies of ``segan_pytorch_tpu/metrics``
(``composite``, ``pesq``, ``pesq_native``, ``perceptual``). Numpy, scipy and ctypes
only: the evaluation pool's workers import this package and nothing else of the port."""
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
