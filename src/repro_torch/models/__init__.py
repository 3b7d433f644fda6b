"""The model stack of the port: the serving path of the hybrid (hymba)
and dense-GQA (glm4, olmo, h2o-danube, nemotron) families."""

from .convert import params_from_jax  # noqa: F401
from .model import (  # noqa: F401
    decode_step,
    forward,
    init_cache,
    init_params,
    layer_windows,
    prefill,
)
