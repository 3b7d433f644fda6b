"""The model stack of the port: the serving path of the hybrid (hymba),
dense-GQA (glm4, olmo, h2o-danube, nemotron), pure-SSM (mamba2), MoE
(qwen3-moe; deepseek-v3, with MLA), encoder-decoder (seamless-m4t) and
VLM (internvl2) families, and the training loss (``train_loss``)."""

from .convert import params_from_jax  # noqa: F401
from .model import (  # noqa: F401
    decode_step,
    forward,
    init_cache,
    init_params,
    layer_windows,
    prefill,
    softmax_xent,
    train_loss,
)
from .moe import MoEDispatch, dispatch_from_plan, identity_dispatch  # noqa: F401
