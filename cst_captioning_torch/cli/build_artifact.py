"""Build a serving artifact (the elastic fleet's deploy unit):

  python -m cst_captioning_torch.cli.build_artifact \\
      --preset msrvtt_serve_beam5 \\
      --checkpoint checkpoints/msrvtt_cst_ms_scb/best \\
      --data.vocab_file vocab.json --out artifacts/msrvtt_serve

Loads the checkpoint once, enumerates every slot-loop variant and
admission encode from the loop's own ladder code, builds (``nvcc``, on
the card) the kernel libraries the engine's serving paths launch, and
publishes a versioned artifact directory (manifest, params, vocabulary,
``kernels/``) atomically under ``--out`` (``serving/artifact.py``).  A
replica then boots from it with ``cli/serve.py --artifact <dir>`` (or
``InferenceEngine.from_artifact``) with no ``nvcc`` run.

Prints one JSON line: artifact path, version, whether it was written,
build seconds, on-disk bytes, variant counts and kernels.
``--random-init`` builds from fresh weights (load-test artifacts; the
captions are noise).  Config overrides (``--serving.dtype bf16``,
``--model.feature_fusion attention``, ...) shape the engine as for
``cli/serve.py``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from cst_captioning_torch.config import parse_cli


def main(argv=None, device=None) -> int:
    """``device``: ``cuda`` unless the caller passes ``"cpu"``."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--random-init", action="store_true",
                        help="build from random weights (load-test "
                             "artifacts only)")
    parser.add_argument("--out", required=True,
                        help="artifact root directory (versions publish "
                             "beneath it)")
    known, rest = parser.parse_known_args(argv)
    cfg = parse_cli(rest)
    if not known.checkpoint and not known.random_init:
        print("build_artifact: need --checkpoint PATH (or --random-init "
              "for a weights-free load-test artifact)", file=sys.stderr)
        return 2

    from cst_captioning_torch.serving.artifact import build_artifact
    from cst_captioning_torch.serving.engine import InferenceEngine

    # The build decodes nothing: a boot walks the ladder itself.
    cfg.serving.warmup = False
    engine = InferenceEngine(cfg, checkpoint=known.checkpoint,
                             random_init=known.random_init, device=device)
    print(json.dumps(build_artifact(engine, known.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
