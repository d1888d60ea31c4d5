"""Distill the speculative-decode draft LSTM (port of the JAX package's
``cli/distill_draft.py``):

  python -m cst_captioning_torch.cli.distill_draft \\
      --preset msrvtt_serve_beam5 --serving.decode_mode greedy \\
      --checkpoint checkpoints/msrvtt_cst_ms_scb/best \\
      --out drafts/msrvtt_draft.npz --draft-hidden 128 [--device cpu]

The draft serves with truncation init for free
(``decoding/speculative.py::make_draft_params``); this CLI buys
acceptance on top by teacher-forcing the draft against the full model's
own greedy stream, the stream the verify pass picks from, so the loss
optimizes what speculation pays for.  Correctness never depends on it:
the rejection rule pins emitted tokens to the full model whatever the
draft proposes.

Teacher rollouts run on synthetic feature batches shaped by the config
(the request geometry serving sees), one eager decode step at a time
(``_teacher_batch``); pass a checkpoint of the port for a deployable
draft or ``--random-init`` to exercise the pipeline.  Each update is
teacher-forced cross-entropy through ``draft_logits`` under autograd and
one Adam step with optax's defaults (the port's ``training/steps.py::
Optimizer``: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
bias-corrected).  Runs on the card unless ``--device cpu`` is given.
Writes the ``.npz`` the ``serving.speculative.draft_params`` knob names
(the reference's key set, so either package loads it) and prints one
JSON line: output path, steps, draft width, final loss and the teacher
match rate of the first and last batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

from cst_captioning_torch.config import TrainConfig, parse_cli


def _make_update(opt, suppress_unk: bool):
    """One distillation step over ``opt.params`` (the draft tree):
    teacher-forced XE of the draft stream against the teacher's greedy
    tokens, then one ``opt`` update; returns ``update(seqs) -> (loss,
    teacher-match rate)`` (the greedy agreement, the acceptance proxy)."""
    import torch

    from cst_captioning_torch.constants import PAD_ID
    from cst_captioning_torch.decoding.speculative import draft_logits

    dp = opt.params

    def loss_fn(seqs):
        # seqs (B, T+1): BOS column, then the teacher's greedy tokens,
        # PAD after EOS.  Feed seqs[:, :-1], predict seqs[:, 1:].
        B = seqs.shape[0]
        hd = dp["draft_cell_b"].shape[0] // 4
        tgt = seqs[:, 1:].T.long()                    # (T, B)
        mask = (tgt != PAD_ID).float()                # EOS kept, pads out
        carry = torch.zeros((2, B, hd), dtype=torch.float32,
                            device=seqs.device)
        steps = []
        for tok in seqs[:, :-1].T:
            carry, logits = draft_logits(dp, carry, tok, suppress_unk)
            steps.append(logits)
        logits = torch.stack(steps)                   # (T, B, V)
        logp = torch.log_softmax(logits, dim=-1)
        ll = logp.gather(-1, tgt[..., None])[..., 0]
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = -(ll * mask).sum() / denom
        agree = (logits.argmax(dim=-1) == tgt).float()
        return loss, (agree * mask).sum() / denom

    def update(seqs):
        with torch.enable_grad():
            loss, agree = loss_fn(seqs)
            grads = torch.autograd.grad(loss, list(dp.values()))
        opt.step(dict(zip(dp, grads)))
        return loss.detach(), agree.detach()

    return update


def _teacher_batch(engine, rng, batch: int, max_len: int):
    """One synthetic batch and the full model's greedy stream over it:
    ``seqs`` (B, max_len+1) int64 on the engine's device, BOS column
    first, PAD after EOS; finished rows are fed EOS (the serving loop's
    dead-row rule).  The pick is the argmax of the decode-policy logits
    (lowest index of the largest), as the reference's."""
    import numpy as np
    import torch

    from cst_captioning_torch.constants import BOS_ID, EOS_ID, PAD_ID
    from cst_captioning_torch.decoding.core import select_top

    d = engine.cfg.data
    dev = engine.device
    feats = {m: torch.from_numpy(rng.standard_normal(
        (batch, d.max_frames, d.feature_dims[m])).astype(np.float32)).to(dev)
        for m in d.feature_modalities}
    masks = {m: torch.ones((batch, d.max_frames), dtype=torch.float32,
                           device=dev) for m in feats}
    cat = (torch.from_numpy(rng.integers(0, 20, (batch,)).astype(
        np.int64)).to(dev) if engine.model.use_category else None)
    model = engine.model
    with torch.no_grad():
        state, cache = model.init_decode(feats, masks, cat)
        tok = torch.full((batch,), BOS_ID, dtype=torch.int64, device=dev)
        finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
        cols = [tok]
        for _ in range(max_len):
            state, logits = model.decode_logits(state, cache, tok)
            nxt = select_top(logits, 1)[1][:, 0]
            col = torch.where(finished, PAD_ID, nxt)
            cols.append(col)
            finished = finished | (col == EOS_ID)
            tok = torch.where(finished, EOS_ID, col)
    return torch.stack(cols, dim=1)


def adam(params, lr: float):
    """optax's ``adam(lr)`` over ``params`` (the port's ``Optimizer``)."""
    from cst_captioning_torch.training.steps import Optimizer

    cfg = dataclasses.replace(
        TrainConfig(), optimizer="adam", learning_rate=float(lr),
        lr_decay_every=0, grad_clip=0.0, weight_decay=0.0, beta1=0.9,
        beta2=0.999, epsilon=1e-8)
    return Optimizer(params, cfg, steps_per_epoch=1)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--random-init", action="store_true",
                        help="distill against random weights (pipeline "
                             "smoke only)")
    parser.add_argument("--out", required=True, help="output .npz path")
    parser.add_argument("--draft-hidden", type=int, default=128)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--max-len", type=int, default=0,
                        help="teacher rollout length (0 = data.max_seq_len)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    known, rest = parser.parse_known_args(argv)
    cfg = parse_cli(rest)
    if not known.checkpoint and not known.random_init:
        print("distill_draft: need --checkpoint PATH (or --random-init "
              "for a pipeline smoke run)", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from cst_captioning_torch.decoding.speculative import (
        draft_to_device,
        make_draft_params,
        save_draft_params,
    )
    from cst_captioning_torch.serving.engine import InferenceEngine

    # The engine is the checkpoint / vocab / quantization loader here: no
    # warmup, no slot decoder.
    cfg.serving.warmup = False
    cfg.serving.continuous = False
    engine = InferenceEngine(cfg, checkpoint=known.checkpoint,
                             random_init=known.random_init,
                             device=known.device)
    max_len = known.max_len or int(cfg.data.max_seq_len)
    suppress = bool(engine.model.decode_suppress_unk)
    dp = draft_to_device(make_draft_params(engine.model.state_dict(),
                                           known.draft_hidden), engine.device)
    for v in dp.values():
        v.requires_grad_(True)
    update = _make_update(adam(dp, known.lr), suppress)

    rng = np.random.default_rng(known.seed)
    loss = agree = agree0 = None
    for step in range(known.steps):
        seqs = _teacher_batch(engine, rng, known.batch, max_len)
        loss, agree = update(seqs)
        if agree0 is None:
            agree0 = float(agree)
        if step % 50 == 0:
            logging.info("step %d: loss %.4f, teacher-match %.3f", step,
                         float(loss), float(agree))
    save_draft_params(known.out, dp)
    print(json.dumps({
        "out": known.out,
        "steps": known.steps,
        "draft_hidden": known.draft_hidden,
        "final_loss": None if loss is None else float(loss),
        "teacher_match_first": agree0,
        "teacher_match_final": None if agree is None else float(agree),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
