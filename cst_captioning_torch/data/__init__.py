"""Host-side data: vocabulary, datasets (in-memory and synthetic), the
fixed-shape batch iterator with device prefetch, and config -> dataset
construction.  The h5 and packed readers are not ported yet
(ROADMAP.md Queue 1, item 4)."""

from cst_captioning_torch.data.build import (  # noqa: F401
    build_dataset,
    load_consensus_weights,
)
from cst_captioning_torch.data.datasets import (  # noqa: F401
    CaptionDataset,
    InMemoryDataset,
    make_synthetic_dataset,
)
from cst_captioning_torch.data.loader import (  # noqa: F401
    Batch,
    BatchIterator,
    prefetch_to_device,
    subsample_frames,
)
from cst_captioning_torch.data.vocab import (  # noqa: F401
    Vocabulary,
    decode_sequence,
)
