"""Online caption-serving CLI of the port:

  python -m cst_captioning_torch.cli.serve --preset msrvtt_serve_beam5 \\
      --checkpoint CKPT_DIR --data.vocab_file vocab.json \\
      [--serving.port 8000] \\
      [--serving.decode_mode greedy] [--model.feature_fusion attention] \\
      [--serving.continuous false] [--serving.dtype bf16|int8w] \\
      [--serving.quant_calibration absmax|percentile]

Serves ``POST /v1/caption`` (plus ``/healthz``, ``/metrics``, ``/stats``
and ``/debug/trace``, ``/debug/flight``, ``/debug/profile?ms=N``) on the
GPU.  By default (the preset's ``serving.continuous = true`` and
``serving.replicas = 0``) through the ``ReplicaSet`` (``serving/
replicas.py``: one replica per local card, each a double-buffered
continuous slot loop, ``serving/slots.py``, on its own CUDA stream;
``--serving.replicas N`` wraps N replicas round-robin onto the cards,
``--serving.replicas 1`` serves one engine's slot loop; per-step decode,
elastic slot banks; under attention fusion every step's context runs
the ``fused_context_attention`` CUDA kernel, and every product the
``row_gemm`` kernel); with ``--serving.continuous false`` through the
batch-at-a-time shape ladder and the fused ``lstm_beam`` /
``lstm_sample`` kernels, or ``attlstm_beam`` / ``attlstm_sample`` under
attention fusion.  ``--serving.dtype bf16`` serves at the bfloat16
compute dtype; ``int8w`` also quantizes the weights once at boot
(``--serving.quant_calibration``) and runs the int8w kernels: the
decoders' ``quant=`` mode on the ladder, the int8 ``row_gemm`` in the
slot loop.  ``--checkpoint`` serves a checkpoint directory of the port
(``params.pt``: what the trainer writes, or what
``tools/import_jax_checkpoint`` makes of a JAX-trained orbax checkpoint;
an orbax directory itself is refused with the two conversion commands);
``--random-init`` serves freshly initialized weights (load tests and
smoke runs — the captions are noise).  Under ``--model.use_category
true`` a request carries its ``category`` id.  SIGTERM drains
gracefully: admissions close, every replica finishes its queued and
in-flight requests (``ReplicaSet.stop``) and, with
``serving.flight_dir`` set, writes its flight dump.

The serving extensions ride the same flags:
``--serving.speculative '{"draft_k": 4}'`` (greedy only) serves through
speculative rounds, the draft truncated from the weights or loaded from
``"draft_params": "draft.npz"`` (``cli/distill_draft.py``);
``--serving.chaos '{"seed": 0, "schedule": [...]}'`` injects the
scheduled faults (``serving/chaos.py::FAULT_SITES``);
``--serving.autoscale '{"min_replicas": 1, "max_replicas": 2}'`` runs
the autoscaler over the ``ReplicaSet``.

``--artifact DIR`` boots from a serving artifact
(``cli/build_artifact.py``: a version directory, or a root whose newest
version is taken) through ``InferenceEngine.from_artifact``: the
artifact's kernel libraries load with no ``nvcc`` run, and its config
decides the model and decode; only ``--serving.host`` / ``--serving.port``
apply from the command line.  ``/healthz`` names the artifact version.

``--preset msrvtt_serve_tp2`` serves one engine whose vocab splits over
two cards (``serving.model_shards``), ``msrvtt_serve_r2xtp2`` a (2, 2)
grid of them and ``msrvtt_serve_int8w_tp2`` the sharded engine at
int8w; a grid larger than the host's cards refuses at boot.
"""

from __future__ import annotations

import argparse
import logging
import sys

from cst_captioning_torch.config import parse_cli


def main(argv=None, device=None) -> int:
    """``device``: ``cuda`` unless the caller passes ``"cpu"``."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--random-init", action="store_true",
                        help="serve random weights (load testing only)")
    parser.add_argument("--artifact", default="",
                        help="boot from a serving artifact "
                             "(cli/build_artifact.py): no nvcc run")
    known, rest = parser.parse_known_args(argv)
    cfg = parse_cli(rest)
    if not known.checkpoint and not known.random_init and not known.artifact:
        print("serve: need --checkpoint PATH, --artifact DIR or "
              "--random-init", file=sys.stderr)
        return 2

    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    if known.artifact:
        engine = InferenceEngine.from_artifact(known.artifact, device=device)
        # The artifact fixes the model and the decode; only the bind
        # address applies from the command line.
        engine.cfg.serving.host = cfg.serving.host
        engine.cfg.serving.port = cfg.serving.port
    else:
        engine = InferenceEngine(cfg, checkpoint=known.checkpoint,
                                 random_init=known.random_init,
                                 device=device)
    server = CaptionServer(engine)
    if hasattr(server.batcher, "replicas"):
        logging.getLogger("cst_captioning_torch.serving").info(
            "replica set: %s", server.batcher.describe())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
