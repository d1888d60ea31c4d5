"""Decoding front ends over the fused kernels."""

from cst_captioning_torch.decoding.beam import (  # noqa: F401
    BeamResult,
    beam_search,
    finalize_beams,
)
