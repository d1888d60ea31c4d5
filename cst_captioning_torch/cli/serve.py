"""Online caption-serving CLI of the port:

  python -m cst_captioning_torch.cli.serve --preset msrvtt_serve_beam5 \\
      --serving.continuous false --random-init \\
      --data.vocab_file vocab.json [--serving.port 8000] \\
      [--serving.decode_mode greedy] [--model.feature_fusion attention]

Serves ``POST /v1/caption`` (plus ``/healthz``, ``/metrics``, ``/stats``)
through the batch-at-a-time shape ladder on the GPU, decoding with the
fused ``lstm_beam`` / ``lstm_sample`` CUDA kernels, or ``attlstm_beam``
/ ``attlstm_sample`` under attention fusion.  ``--random-init``
serves freshly initialized weights (load tests and smoke runs — the
captions are noise).  SIGTERM drains gracefully.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the continuous slot loop (``--serving.continuous true``, the
preset default), ``--checkpoint`` (orbax restore) and ``--artifact``
(AOT serving artifacts).
"""

from __future__ import annotations

import argparse
import logging
import sys

from cst_captioning_torch.config import parse_cli


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--random-init", action="store_true",
                        help="serve random weights (load testing only)")
    parser.add_argument("--artifact", default="")
    known, rest = parser.parse_known_args(argv)
    cfg = parse_cli(rest)
    if known.artifact:
        from cst_captioning_torch.models.captioner import not_ported

        raise not_ported("--artifact (AOT serving artifacts)",
                         "Queue 1, item 6 (serving extensions)")
    if not known.checkpoint and not known.random_init:
        print("serve: need --checkpoint PATH or --random-init",
              file=sys.stderr)
        return 2

    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    engine = InferenceEngine(cfg, checkpoint=known.checkpoint,
                             random_init=known.random_init, device="cuda")
    server = CaptionServer(engine)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
