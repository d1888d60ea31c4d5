"""The caption model (single-layer, meanpool or attention fusion) and
the weight bridge."""

from cst_captioning_torch.models.captioner import (  # noqa: F401
    CaptionModel,
    DecodeCache,
    SampleOutput,
    model_from_config,
)
from cst_captioning_torch.models.weights import (  # noqa: F401
    load_params,
    params_to_state_dict,
    state_dict_to_params,
)
