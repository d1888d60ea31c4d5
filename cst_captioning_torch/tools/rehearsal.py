"""Reference-shaped end-to-end rehearsal (the port of the JAX package's
``tools/rehearsal.py``): the full MSR-VTT pipeline on a fabricated,
learnable corpus with the real file formats at (scaled) real shapes, on
the GPU.

No MSR-VTT/MSVD data ships with the repository, so this tool is the
closest honest substitute for a real-data run, and the exact command
sequence a real run uses:

  1. fabricate ``videodatainfo.json`` (msrvtt annotation format: splits,
     categories, 20 captions/video) and the features of every modality
     (resnet-2048, c3d-4096; compositional, so the captions are
     learnable and CST has real signal);
  2. ``tools/prepare_data``  -> vocab, label arrays, cocofmt GT jsons,
     CIDEr idf table, consensus weights json;
  3. ``data/packed.pack_modality`` -> one packed float16 feature store;
  4. ``cli/pipeline``         -> staged XE -> WXE -> CST_MS (SCB baseline,
     weighted consensus reward) with warm-start chaining;
  5. beam-search eval on the test split against the cocofmt GT.

Two data routes give the same corpus, the same ``prepare`` outputs and
the same training:

* **h5** (``h5py`` importable): the reference's sequence — per-modality
  feature h5s and per-split label h5s, the packed store read back from
  the feature h5s, the splits built from the label h5s (``H5Dataset``);
* **memory** (no ``h5py``, as on a host without it): the same generator
  packs straight into the same ``packed/`` store, ``prepare`` writes
  every output but the label h5s, and each split is a ``PackedDataset``
  holding ``prepare_data.split_labels``' arrays, handed to
  ``run_pipeline(datasets=...)``.

``--reuse-data`` recomputes the memory route's labels from the
annotation json (deterministic), so it works on either route.  The h5
route needs the corpus's label h5s; a corpus built without them reruns
on the memory route.  One log line names the route.

Run (the defaults: a few minutes on one GPU):

    python -m cst_captioning_torch.tools.rehearsal --out-dir OUT
        [--videos 200] [--epochs 3] [--feature-dims resnet=2048,c3d=4096]
        [--corpus v2|branch-trap] [--stages xe,wxe,cst] [--reuse-data]

In Python, ``main(argv, device="cpu")`` runs on the CPU.  Prints one
JSON line: per-stage best val CIDEr and last reward, the final test
metrics and, for the branch-trap corpus, the analytic MLE bound.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from collections import Counter
from typing import Dict, Iterator, List, Tuple

import numpy as np

log = logging.getLogger("cst_captioning_torch.rehearsal")

_NOUNS = [
    "cat", "dog", "man", "woman", "car", "ball", "bird", "horse", "child",
    "robot", "chef", "dancer", "player", "singer", "train", "boat",
    "monkey", "girl", "boy", "band",
]
_VERBS = [
    "runs", "jumps", "sings", "drives", "cooks", "plays", "walks", "flies",
    "dances", "sleeps", "swims", "talks", "rides", "draws",
]
_ADVS = ["quickly", "slowly", "happily", "loudly", "quietly", "gracefully",
         "outside", "indoors"]
_PLACES = ["park", "street", "kitchen", "stage", "field", "river", "room",
           "garden"]


# The corpus-wide generic caption: every video carries `generic_refs`
# copies, so MLE's modal decode is this sentence — whose n-grams appear in
# EVERY video's reference set (df = N, idf ~ 0) and therefore score ~0
# CIDEr-D.  This engineers, at rehearsal scale, exactly the failure mode
# the CST paper targets (generic MLE captions vs consensus-scoring
# specific ones): XE gravitates to it, consensus weighting (WXE)
# de-emphasizes it, and the CST reward must escape it entirely.
_GENERIC = ["a", "person", "is", "doing", "something"]

# Branch-trap corpus: one corpus where MLE provably cannot reach the
# ceiling.  Three reference blocks per video:
#
# * 9x GENERIC   "someone is doing something" — corpus-wide (idf ~ 0,
#   consensus weight ~ 0) but the unweighted mode: plain XE decodes it
#   and scores ~0.
# * 8x DECOY     "the NOUN VERBS ADV j1..j8" — a shared VIDEO-SPECIFIC
#   4-word prefix (the adverb is a per-video function of noun+verb), then
#   eight junk words drawn per REFERENCE from a 200-word junk vocabulary.
# * 3x TARGET    "a NOUN VERBS in the PLACE" — identical copies: the
#   highest-scoring decodable caption, reachable from the WXE policy by
#   first-token exploration.
#
# Why the trap holds, with sim_d = decoy-decoy CIDEr, cross =
# decoy-target CIDEr, D/T = decoy/target counts: the weighted first-token
# mass prefers the decoy branch iff D(D-1)·sim_d > T(T-1)·10 (identical
# targets score 10 with each other), while the best decodable decoy-branch
# caption — the infinite-capacity conditional greedy-decodes ONE decoy
# verbatim, since each junk tail uniquely identifies its reference — loses
# to the target iff (D-1)·sim_d < (T-1)·10 + (D-T)·cross.  Both hold for
# (D-1)·sim_d in an open window that D=8, T=3 with a 4-content-word,
# 8-junk-word decoy places sim_d comfortably inside; the corpus-wide junk
# vocabulary keeps junk idf low so the window does not drift with corpus
# size.
#
# The trap is verified ANALYTICALLY per corpus by analyze_mle_optimum():
# the exact per-video conditional of the reference distribution (the
# optimum any MLE stage can converge to, at any capacity) is greedy-
# decoded with and without consensus weights and scored — establishing
# score(XE*) < score(WXE*) < score(target) before any training runs.
_BT_GENERIC = ["someone", "is", "doing", "something"]
_BT_JUNK_VOCAB = 200
_BT_GENERIC_REFS = 9
_BT_DECOY_REFS = 8
_BT_JUNK_LEN = 8

ANNOTATIONS = "videodatainfo.json"


def draw_corpus(
    num_videos: int,
    feature_dims: Dict[str, int],
    caps_per_video: int = 20,
    max_frames_range=(24, 32),
    noise: float = 0.15,
    seed: int = 0,
    generic_refs: int = 8,
    scene_mix: float = 0.0,
    corpus_kind: str = "v2",
) -> Tuple[dict, Iterator[Tuple[str, Iterator[np.ndarray]]]]:
    """The corpus ``fabricate`` writes, drawn from one
    ``np.random.RandomState(seed)`` in the reference's order: ``(the
    annotation json's object, modalities)``.  ``modalities`` yields
    ``(modality, frames)`` in ``feature_dims`` order, ``frames`` one
    float32 (F_i, D) array a video in video order, drawn lazily from the
    shared generator: consume each ``frames`` whole before the next
    modality, as both writers do.

    Features are COMPOSITIONAL: each modality's dim is split into three
    slices holding a per-noun / per-verb / per-place embedding, so a
    model can generalize to (noun, verb, place) combinations never seen
    in training — like real ResNet/C3D features and unlike a lookup
    table of independent per-topic vectors (which caps every stage's val
    CIDEr).

    References per video: ``generic_refs`` copies of the corpus-wide
    generic caption (modal but consensus-worthless, see ``_GENERIC``)
    plus specific variants ("a NOUN VERBS [ADV] [in the PLACE]"), each
    variant rarer than the generic block; ``corpus_kind="branch_trap"``
    draws the ``_BT_*`` blocks instead.

    ``scene_mix`` > 0 makes videos TWO-scene: each video draws a
    distractor place and a mix fraction ~ U(0, min(scene_mix, 0.5)),
    and that fraction of its frames carries the distractor place's
    embedding slice; captions always name the majority place.  Videos
    with a mix near 0.5 are genuinely ambiguous (frame-averaged place
    evidence is a near-even blend of two centroids), so no MLE stage
    can saturate the val metric and expected-reward optimization (CST)
    has a real include-the-place-clause-or-not decision to make.  The
    scene draws use a SEPARATE rng stream, so scene_mix=0 reproduces
    the unmixed corpus bit-for-bit.
    """
    rng = np.random.RandomState(seed)
    n_train = int(num_videos * 0.65)
    n_val = max(1, int(num_videos * 0.1))
    videos, sentences = [], []
    topics: List[tuple] = []
    for i in range(num_videos):
        split = (
            "train" if i < n_train
            else "val" if i < n_train + n_val
            else "test"
        )
        t = (rng.randint(len(_NOUNS)), rng.randint(len(_VERBS)),
             rng.randint(len(_PLACES)))
        topics.append(t)
        videos.append({
            "video_id": f"video{i}",
            "split": split,
            "category": int(t[0] % 20),
        })
        n_i, v_i, p_i = t
        for c in range(caps_per_video):
            if corpus_kind == "branch_trap":
                words = _branch_trap_ref(rng, c, n_i, v_i, p_i)
            elif c < generic_refs:
                words = list(_GENERIC)
            else:
                words = ["a", _NOUNS[n_i], _VERBS[v_i]]
                if c % 2:
                    words.append(_ADVS[(n_i + v_i + c) % len(_ADVS)])
                if c % 3 == 0:
                    words += ["in", "the", _PLACES[p_i]]
            sentences.append(
                {"video_id": f"video{i}", "caption": " ".join(words)}
            )

    # Two-scene plan (distractor place + mix fraction per video), from a
    # separate stream so scene_mix=0 corpora are bit-identical to the
    # unmixed generator.  frac <= 0.5 keeps the captioned place the
    # majority scene.
    scene_plan = []
    if scene_mix > 0.0:
        rng_scene = np.random.RandomState(seed + 77)
        cap = min(float(scene_mix), 0.5)
        for n_i, v_i, p_i in topics:
            q_i = (p_i + 1 + rng_scene.randint(len(_PLACES) - 1)) % len(
                _PLACES
            )
            scene_plan.append((q_i, float(rng_scene.uniform(0.0, cap))))

    def video_frames(d, noun_emb, verb_emb, place_emb):
        dn = dv = d // 3
        dp = d - dn - dv
        for i, (n_i, v_i, p_i) in enumerate(topics):
            base = np.concatenate(
                [noun_emb[n_i], verb_emb[v_i], place_emb[p_i]]
            )
            nf = rng.randint(*max_frames_range)
            frames = base[None, :] + noise * rng.randn(nf, d).astype(
                np.float32
            )
            if scene_mix > 0.0:
                # All scene-mix randomness (frame choice AND the
                # distractor frames' noise) comes from the per-video
                # scene rng: the main stream is untouched, so mixing
                # perturbs ONLY place slices vs the unmixed corpus.
                q_i, frac = scene_plan[i]
                k = int(round(frac * nf))
                srng = _scene_rng(seed, i)
                which = srng.permutation(nf)[:k]
                frames[which, dn + dv:] = (
                    place_emb[q_i][None, :]
                    + noise * srng.randn(k, dp).astype(np.float32)
                )
            yield frames.astype(np.float32)

    def modalities():
        # Compositional atom embeddings at real dims (seed-independent so
        # features cluster identically across runs), noisy per-frame
        # copies.
        atom_rng = np.random.RandomState(20260730)
        for m, d in feature_dims.items():
            dn = dv = d // 3
            dp = d - dn - dv
            noun_emb = atom_rng.randn(len(_NOUNS), dn).astype(np.float32)
            verb_emb = atom_rng.randn(len(_VERBS), dv).astype(np.float32)
            place_emb = atom_rng.randn(len(_PLACES), dp).astype(np.float32)
            yield m, video_frames(d, noun_emb, verb_emb, place_emb)

    return {"videos": videos, "sentences": sentences}, modalities()


def _write_annotations(out_dir: str, ann: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, ANNOTATIONS)
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def fabricate(
    out_dir: str,
    num_videos: int,
    feature_dims: Dict[str, int],
    caps_per_video: int = 20,
    max_frames_range=(24, 32),
    noise: float = 0.15,
    seed: int = 0,
    generic_refs: int = 8,
    scene_mix: float = 0.0,
    corpus_kind: str = "v2",
) -> Dict[str, str]:
    """Write msrvtt-format annotations + one per-video feature h5 per
    modality (``draw_corpus``'s corpus: the reference's files, byte for
    byte and bitwise; needs ``h5py``).  Returns {"annotations": path,
    modality: h5 path}."""
    import h5py

    ann, modalities = draw_corpus(
        num_videos, feature_dims, caps_per_video=caps_per_video,
        max_frames_range=max_frames_range, noise=noise, seed=seed,
        generic_refs=generic_refs, scene_mix=scene_mix,
        corpus_kind=corpus_kind)
    paths = {"annotations": _write_annotations(out_dir, ann)}
    for m, frames in modalities:
        path = os.path.join(out_dir, f"{m}.h5")
        with h5py.File(path, "w") as f:
            for i, fr in enumerate(frames):
                f.create_dataset(f"video{i}", data=fr)
        paths[m] = path
    return paths


def fabricate_packed(out_dir: str, packed_dir: str, num_videos: int,
                     feature_dims: Dict[str, int], max_frames: int,
                     dtype: str = "float16", **corpus) -> Dict[str, str]:
    """``fabricate``'s corpus with no h5: the annotations json, and the
    features packed straight into ``packed_dir`` at ``max_frames`` and
    ``dtype`` (the store ``pack_modality`` makes from ``fabricate``'s
    h5s).  ``corpus``: ``draw_corpus``'s keywords.  Returns
    {"annotations": path, modality: packed array path}."""
    from cst_captioning_torch.data.packed import pack_modality

    ann, modalities = draw_corpus(num_videos, feature_dims, **corpus)
    paths = {"annotations": _write_annotations(out_dir, ann)}
    vids = [f"video{i}" for i in range(num_videos)]
    for m, frames in modalities:
        paths[m] = pack_modality(packed_dir, m, vids, frames, max_frames,
                                 feature_dims[m], dtype=dtype)
    return paths


def _scene_rng(seed: int, video: int):
    """Per-video rng for scene-mix frame choices — deterministic and
    identical across modalities so resnet and c3d tell one story."""
    return np.random.RandomState((seed * 1_000_003 + video * 7 + 1)
                                 % (2**31 - 1))


def _branch_trap_ref(rng, c: int, n_i: int, v_i: int, p_i: int):
    """Reference ``c`` of a branch-trap video (see _BT_* block comment)."""
    if c < _BT_GENERIC_REFS:
        return list(_BT_GENERIC)
    if c < _BT_GENERIC_REFS + _BT_DECOY_REFS:
        junk = [
            f"zz{rng.randint(_BT_JUNK_VOCAB)}" for _ in range(_BT_JUNK_LEN)
        ]
        adv = _ADVS[(n_i + v_i) % len(_ADVS)]
        return ["the", _NOUNS[n_i], _VERBS[v_i], adv] + junk
    return ["a", _NOUNS[n_i], _VERBS[v_i], "in", "the", _PLACES[p_i]]


def analyze_mle_optimum(ann_path: str, consensus_path: str,
                        split: str = "val") -> Dict:
    """Exact infinite-capacity MLE analysis of a fabricated corpus.

    The optimum ANY cross-entropy stage can converge to — at any model
    capacity, any epoch budget — is the true conditional of the
    per-video reference distribution (token-level MLE's global optimum).
    That conditional is computable exactly from the corpus: P(tok |
    video, prefix) is the (weighted) frequency of ``tok`` among the
    video's references extending ``prefix``.  Greedy-decoding it gives
    the best caption XE (uniform weights) or WXE (consensus weights)
    greedy decoding can EVER emit; scoring those decodes against the
    split's references with corpus-df CIDEr-D bounds every MLE stage
    from above, before any training runs.

    Returns mean scores for the XE optimum, the WXE optimum, and the
    per-video target caption ("a NOUN VERBS in the PLACE" — the known
    high-consensus candidate a reward-optimizing stage can reach).
    """
    from cst_captioning_torch.metrics.cider import CiderD

    with open(ann_path) as f:
        ann = json.load(f)
    split_vids = [v["video_id"] for v in ann["videos"]
                  if v["split"] == split]
    refs: Dict[str, List[str]] = {v: [] for v in split_vids}
    for s in ann["sentences"]:
        if s["video_id"] in refs:
            refs[s["video_id"]].append(s["caption"])
    weights: Dict[str, List[float]] = {}
    if os.path.exists(consensus_path):
        with open(consensus_path) as f:
            weights = json.load(f)

    def greedy_conditional(caps: List[str], w: List[float]) -> str:
        """Greedy decode of the exact weighted conditional, max 20 toks."""
        out: List[str] = []
        for _ in range(20):
            mass: Dict[str, float] = {}
            for cap, cw in zip(caps, w):
                toks = cap.split()
                if toks[: len(out)] == out:
                    nxt = toks[len(out)] if len(toks) > len(out) else "</s>"
                    mass[nxt] = mass.get(nxt, 0.0) + cw
            if not mass:
                break
            # Deterministic tie-break (alphabetical) like argmax over a
            # fixed vocab order.
            best = max(sorted(mass), key=lambda k: mass[k])
            if best == "</s>":
                break
            out.append(best)
        return " ".join(out)

    gts = {v: refs[v] for v in split_vids}
    cands = {}
    for kind in ("xe", "wxe", "target"):
        per_video = {}
        for v in split_vids:
            caps = refs[v]
            if kind == "xe":
                per_video[v] = [greedy_conditional(caps, [1.0] * len(caps))]
            elif kind == "wxe":
                w = weights.get(v, [1.0] * len(caps))
                per_video[v] = [greedy_conditional(caps, list(w))]
            else:
                # The identical-copies block is the known high-consensus
                # candidate; recover it as the modal non-generic,
                # non-decoy reference (it appears ``caps_per_video -
                # generic - decoy`` times verbatim).
                filtered = [
                    c for c in caps
                    if not c.startswith("the ") and "someone" not in c
                ] or caps
                per_video[v] = [Counter(filtered).most_common(1)[0][0]]
        cands[kind] = per_video

    scorer = CiderD(df_mode="corpus")
    out = {}
    for kind, per_video in cands.items():
        mean, _ = scorer.compute_score(gts, per_video)
        out[f"{kind}_greedy_optimum_cider"] = round(float(mean), 4)
        out[f"{kind}_example"] = per_video[split_vids[0]][0]
    return out


def data_route(prep: Dict[str, str] = None) -> str:
    """``"h5"`` when ``h5py`` imports and the corpus has (or, with
    ``prep`` None, will have) its label h5s, else ``"memory"``."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return "memory"
    if prep is not None and "labels_train" not in prep:
        return "memory"
    return "h5"


def memory_splits(ann_path: str, prep: Dict[str, str], packed_dir: str,
                  modalities, max_words: int):
    """The memory route's splits: ``PackedDataset``s over the packed
    store, their labels ``prepare_data.split_labels``' arrays recomputed
    from the annotation json, the consensus weights read back from the
    ``consensus_<split>.json`` files ``prepare`` wrote (the same float32
    values; computing them is prep's costly step), the vocabulary
    ``prep``'s."""
    from cst_captioning_torch.data.datasets import PackedDataset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.tools.prepare_data import read_annotations

    ann = read_annotations(ann_path, "msrvtt", min_freq=1)
    vocab = Vocabulary.load(prep["vocab"])
    dirs = {m: packed_dir for m in modalities}
    out = {}
    for split in ("train", "val", "test"):
        if split not in ann.splits:
            continue
        with open(prep[f"consensus_{split}"]) as f:
            lab = ann.labels(split, max_words, weights=json.load(f))
        out[split] = PackedDataset(
            vocab, lab.video_ids, lab.captions, lab.cap_start, lab.cap_end,
            [lab.refs[v] for v in lab.video_ids], dirs, weights=lab.weights,
            categories=lab.category)
    return out


def feature_dims(args) -> Dict[str, int]:
    dims = dict(kv.split("=") for kv in args.feature_dims.split(","))
    return {m: int(d) for m, d in dims.items()}


def build_corpus(args) -> Tuple[Dict[str, str], str]:
    """Steps 1-3 of the module docstring under ``args.out_dir`` (or, with
    ``--reuse-data``, the cached corpus after its manifest check):
    ``(prep paths, data route)``."""
    from cst_captioning_torch.tools.prepare_data import prepare

    out = args.out_dir
    dims = feature_dims(args)
    packed_dir = os.path.join(out, "packed")
    raw_dir = os.path.join(out, "raw")
    prep_dir = os.path.join(out, "prep")
    manifest_path = os.path.join(prep_dir, "manifest.json")
    # Everything that shapes the corpus: a --reuse-data arm must match the
    # cached corpus on ALL of these or it would silently sweep over the
    # wrong data while its summary records the new flags.
    corpus_kind = args.corpus.replace("-", "_")
    corpus_args = {
        "videos": args.videos,
        "seed": args.seed,
        "generic_refs": args.generic_refs,
        "scene_mix": args.scene_mix,
        "feature_dims": dims,
        "max_frames": args.max_frames,
        "max_words": args.max_words,
        "corpus_kind": corpus_kind,
    }
    if args.reuse_data and os.path.exists(manifest_path):
        # Hyperparameter-sweep mode: the fabricate/prepare/pack steps are
        # deterministic in the corpus args, so arms sharing an --out-dir
        # reuse the corpus and only retrain their stage(s).
        with open(manifest_path) as f:
            manifest = json.load(f)
        # Manifests written before newer corpus knobs existed imply those
        # knobs' no-op defaults (documented bit-identical corpora).
        manifest["corpus_args"].setdefault("scene_mix", 0.0)
        manifest["corpus_args"].setdefault("corpus_kind", "v2")
        if manifest["corpus_args"] != corpus_args:
            raise ValueError(
                "--reuse-data: cached corpus was built with "
                f"{manifest['corpus_args']}, this run asks for "
                f"{corpus_args} — use a fresh --out-dir"
            )
        prep = manifest["prep"]
        return prep, data_route(prep)
    if args.reuse_data:
        raise FileNotFoundError(
            f"--reuse-data: no corpus manifest at {manifest_path} — run "
            "once without --reuse-data first"
        )
    route = data_route()
    corpus = dict(seed=args.seed, generic_refs=args.generic_refs,
                  scene_mix=args.scene_mix, corpus_kind=corpus_kind)
    if route == "h5":
        raw = fabricate(raw_dir, args.videos, dims, **corpus)
        prep = prepare(raw["annotations"], "msrvtt", prep_dir, min_freq=1,
                       max_words=args.max_words)
        # ONE packed store over every video: all three splits' datasets
        # share cfg.data.feature_files, and H5Dataset remaps split ->
        # packed indices by video id.
        import h5py

        from cst_captioning_torch.data.packed import pack_modality

        vids_all = [f"video{i}" for i in range(args.videos)]
        for m in dims:
            with h5py.File(raw[m], "r") as f:
                pack_modality(
                    packed_dir, m, vids_all, (f[v][()] for v in vids_all),
                    args.max_frames, dims[m], dtype="float16",
                )
    else:
        raw = fabricate_packed(raw_dir, packed_dir, args.videos, dims,
                               args.max_frames, dtype="float16", **corpus)
        prep = prepare(raw["annotations"], "msrvtt", prep_dir, min_freq=1,
                       max_words=args.max_words, label_h5=False)
    # Written LAST: its presence certifies prepare+pack completed.
    with open(manifest_path, "w") as f:
        json.dump({"corpus_args": corpus_args, "prep": prep}, f)
    return prep, route


def rehearsal_config(args, prep: Dict[str, str]):
    """The pipeline's base configuration for ``main``'s parsed arguments
    over the corpus whose ``prepare`` outputs are ``prep``."""
    from cst_captioning_torch.config import get_preset

    out = args.out_dir
    dims = feature_dims(args)
    packed_dir = os.path.join(out, "packed")
    prep_dir = os.path.join(out, "prep")
    cfg = get_preset("msrvtt_resnet_c3d_xe")
    cfg.name = args.run_name
    if args.train_seed is not None:
        cfg.train.seed = args.train_seed
    cfg.data.feature_modalities = list(dims)
    cfg.data.feature_dims = dims
    cfg.data.label_file = os.path.join(prep_dir, "labels_{split}.h5")
    cfg.data.vocab_file = prep["vocab"]
    cfg.data.idf_file = prep["idf"]
    cfg.train.start_from = args.start_from
    cfg.data.consensus_file = os.path.join(prep_dir, "consensus_{split}.json")
    cfg.data.cocofmt_files = {
        s: prep[f"cocofmt_{s}"] for s in ("train", "val", "test")
    }
    cfg.data.feature_files = {m: packed_dir for m in dims}
    cfg.data.batch_size = args.batch_size
    cfg.data.max_frames = args.max_frames
    cfg.data.max_seq_len = args.max_words
    cfg.train.checkpoint_dir = os.path.join(out, "checkpoints")
    cfg.train.max_epochs = args.epochs
    cfg.train.max_patience = 0
    cfg.train.cst_num_samples = args.cst_samples
    cfg.train.cst_weighted_reward = True      # the weighted consensus reward
    cfg.train.log_every = 50
    cfg.eval.beam_size = args.beam_size
    cfg.eval.max_decode_len = args.max_words
    cfg.eval.metrics = ["Bleu_4", "METEOR", "ROUGE_L", "CIDEr"]
    if args.use_pallas:
        cfg.model.use_pallas_lstm = True
    if args.fusion:
        cfg.model.feature_fusion = args.fusion
    if args.att_hidden:
        cfg.model.att_hidden_size = args.att_hidden
    return cfg


def run(args, device=None) -> Dict:
    """One rehearsal (``main``'s parsed arguments); returns the summary.
    ``device``: ``cuda`` unless the caller passes ``"cpu"``."""
    from cst_captioning_torch.cli.pipeline import run_pipeline
    from cst_captioning_torch.device import resolve_device

    device = resolve_device(device)
    out = args.out_dir
    dims = feature_dims(args)
    corpus_kind = args.corpus.replace("-", "_")
    packed_dir = os.path.join(out, "packed")
    prep_dir = os.path.join(out, "prep")
    prep, route = build_corpus(args)
    cfg = rehearsal_config(args, prep)

    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    # CST sweep knobs: override the cst/cst_greedy stage recipe without
    # touching the shared STAGE_RECIPES.
    cst_over = {}
    if args.cst_lr is not None:
        cst_over["train.learning_rate"] = args.cst_lr
    if args.cst_baseline is not None:
        cst_over["train.cst_baseline"] = args.cst_baseline
    if args.cst_temperature is not None:
        cst_over["train.sample_temperature"] = args.cst_temperature
    if args.cst_lr_decay_every is not None:
        cst_over["train.lr_decay_every"] = args.cst_lr_decay_every
    overrides = {s: dict(cst_over) for s in ("cst", "cst_greedy")}

    ann_path = os.path.join(out, "raw", ANNOTATIONS)
    datasets = None
    if route == "memory":
        datasets = memory_splits(ann_path, prep, packed_dir, dims,
                                 args.max_words)
    log.info("rehearsal data route: %s (%s)", route,
             "label h5s and H5Dataset" if route == "h5" else
             "labels in memory, PackedDataset; no h5 file written or read")
    results = run_pipeline(
        cfg, stages, eval_split="test", stage_overrides=overrides,
        device=device, datasets=datasets,
    )
    summary = {
        "videos": args.videos,
        "feature_dims": dims,
        "run_name": args.run_name,
        "corpus_kind": corpus_kind,
        "train_seed": (
            args.train_seed if args.train_seed is not None
            else cfg.train.seed
        ),
        "cst_overrides": cst_over,
        "model_overrides": {
            k: v for k, v in (
                ("feature_fusion", args.fusion),
                ("att_hidden_size", args.att_hidden),
            ) if v
        },
        "scene_mix": args.scene_mix,
        "stages": {},
        "test_scores": results.get("eval", {}).get("scores", {}),
    }
    if corpus_kind == "branch_trap":
        # The analytic MLE bound (see analyze_mle_optimum): computed per
        # run so the trained stages can be read against the exact optimum
        # any XE/WXE stage could ever reach on this corpus.
        for split in ("val", "test"):
            summary[f"mle_optimum_{split}"] = analyze_mle_optimum(
                ann_path, os.path.join(prep_dir, f"consensus_{split}.json"),
                split=split,
            )
    for stage in stages:
        hist = results.get(stage, {})
        cider = [
            e["val"]["CIDEr"] for e in hist.values()
            if isinstance(e, dict) and "val" in e and "CIDEr" in e["val"]
        ]
        rewards = [
            e["reward"] for e in hist.values()
            if isinstance(e, dict) and "reward" in e
        ]
        summary["stages"][stage] = {
            "best_val_cider": max(cider) if cider else None,
            "final_reward": rewards[-1] if rewards else None,
        }
    return summary


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("rehearsal")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--videos", type=int, default=200)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-frames", type=int, default=28)
    p.add_argument("--max-words", type=int, default=12)
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--cst-samples", type=int, default=5)
    p.add_argument("--feature-dims", default="resnet=2048,c3d=4096")
    p.add_argument("--use-pallas", action="store_true",
                   help="set model.use_pallas_lstm (the port's CUDA "
                        "kernels)")
    p.add_argument("--fusion", default=None,
                   choices=["meanpool", "attention"],
                   help="override model.feature_fusion")
    p.add_argument("--att-hidden", type=int, default=None,
                   help="override model.att_hidden_size (A-width sweeps)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-seed", type=int, default=None,
                   help="training seed (init/shuffle/sampling rng) — "
                        "multi-seed sweeps vary this while --seed keeps "
                        "the corpus fixed")
    p.add_argument("--corpus", default="v2",
                   choices=["v2", "branch-trap"],
                   help="corpus generator: v2 (compositional + generic "
                        "trap) or branch-trap (weighted-MLE provably "
                        "cannot reach the ceiling; see module docs)")
    p.add_argument("--generic-refs", type=int, default=8,
                   help="per-video copies of the corpus-wide generic "
                        "caption (0 = round-2 style corpus)")
    p.add_argument("--scene-mix", type=float, default=0.0,
                   help="fraction of frames showing a distractor place "
                        "(two-scene videos; captions name the majority "
                        "place)")
    # Sweep mode: reuse the corpus, train a stage subset, warm-start from
    # an existing checkpoint, tune the CST recipe.
    p.add_argument("--stages", default="xe,wxe,cst",
                   help="comma list from {xe,wxe,cst,cst_greedy}")
    p.add_argument("--run-name", default="rehearsal",
                   help="checkpoint namespace (sweep arms must differ)")
    p.add_argument("--reuse-data", action="store_true",
                   help="reuse out-dir's prep/packed corpus if present")
    p.add_argument("--start-from", default="",
                   help="warm-start checkpoint for the first stage")
    p.add_argument("--cst-lr", type=float, default=None)
    p.add_argument("--cst-baseline", default=None,
                   choices=[None, "greedy", "scb", "gt_consensus", "none"])
    p.add_argument("--cst-temperature", type=float, default=None)
    p.add_argument("--cst-lr-decay-every", type=int, default=None,
                   help="epochs between CST lr decays (0 = constant lr)")
    return p


def main(argv=None, device=None) -> int:
    """``device``: ``cuda`` unless the caller passes ``"cpu"``."""
    logging.basicConfig(level=logging.INFO)
    summary = run(parser().parse_args(argv), device=device)
    print(json.dumps(summary, default=str))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
