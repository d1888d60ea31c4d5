"""Host-side data: vocabulary, datasets (in-memory, h5 with packed
feature directories, labels in memory beside packed features, synthetic), the packed feature layout, the
fixed-shape batch iterator with device prefetch, and config -> dataset
construction."""

from cst_captioning_torch.data.build import (  # noqa: F401
    build_dataset,
    load_consensus_weights,
)
from cst_captioning_torch.data.datasets import (  # noqa: F401
    CaptionDataset,
    H5Dataset,
    InMemoryDataset,
    PackedDataset,
    make_synthetic_dataset,
)
from cst_captioning_torch.data.loader import (  # noqa: F401
    Batch,
    BatchIterator,
    prefetch_to_device,
    subsample_frames,
)
from cst_captioning_torch.data.packed import (  # noqa: F401
    PackedSource,
    is_packed_dir,
    pack_dataset,
)
from cst_captioning_torch.data.vocab import (  # noqa: F401
    Vocabulary,
    decode_sequence,
)
