"""Convert per-video feature h5s into the packed contiguous layout
(``data/packed.py``), the port's copy of the JAX package's
``tools/pack_features.py``.  Point ``data.feature_files`` at the output
directory afterwards.

Run::

    python -m cst_captioning_torch.tools.pack_features \
        --label-file data/msrvtt/labels_train.h5 \
        --features resnet=feats/resnet.h5 c3d=feats/c3d.h5 \
        --out-dir data/msrvtt/packed_train \
        --max-frames 28 --dtype float16

``--max-frames`` should equal the training ``data.max_frames``: frames
are uniformly subsampled at pack time with the loader's
``subsample_frames``, so batches are bit-identical to the per-video
path.  Needs ``h5py``.
"""

from __future__ import annotations

import argparse
from typing import Dict

from cst_captioning_torch.data.packed import pack_modality


def pack_from_h5(
    label_file: str,
    feature_files: Dict[str, str],
    out_dir: str,
    max_frames: int,
    dtype: str = "float32",
) -> Dict[str, str]:
    """Pack every modality in the label file's video order (so packed
    indices equal dataset indices)."""
    import h5py

    with h5py.File(label_file, "r") as lab:
        vids = [v.decode() if isinstance(v, bytes) else str(v)
                for v in lab["video_ids"][()]]
    paths = {}
    for m, p in feature_files.items():
        with h5py.File(p, "r") as f:
            missing = [v for v in vids if v not in f]
            if missing:
                raise ValueError(
                    f"feature h5 {p} is missing {len(missing)} videos "
                    f"(first: {missing[:3]})")
            dim = int(f[vids[0]].shape[-1])
            paths[m] = pack_modality(out_dir, m, vids,
                                     (f[v][()] for v in vids), max_frames,
                                     dim, dtype=dtype)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser("pack_features")
    p.add_argument("--label-file", required=True)
    p.add_argument("--features", required=True, nargs="+",
                   help="modality=path.h5 pairs")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--max-frames", type=int, default=28)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float16"])
    a = p.parse_args(argv)
    feature_files = dict(kv.split("=", 1) for kv in a.features)
    paths = pack_from_h5(a.label_file, feature_files, a.out_dir,
                         a.max_frames, a.dtype)
    for m, path in sorted(paths.items()):
        print(f"{m}: {path}")


if __name__ == "__main__":
    main()
