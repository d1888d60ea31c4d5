"""Host-side data helpers the serving path needs (vocabulary, frame
subsampling).  The dataset readers and the batch iterator are not
ported yet (ROADMAP.md Queue 1)."""

from cst_captioning_torch.data.loader import subsample_frames  # noqa: F401
from cst_captioning_torch.data.vocab import (  # noqa: F401
    Vocabulary,
    decode_sequence,
)
