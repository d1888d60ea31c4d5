"""Decoding: the per-step decode core and the beam front ends."""

from cst_captioning_torch.decoding.beam import (  # noqa: F401
    BeamResult,
    beam_search,
    beam_search_from_state,
    finalize_beams,
)
