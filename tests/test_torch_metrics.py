"""Port parity: the port's copy of the metric suite
(``cst_captioning_torch.metrics``) scores exactly what the JAX
package's does, bit for bit, on the same corpora."""

import numpy as np
import pytest

from cst_captioning_tpu.metrics import evaluator as jeval
from cst_captioning_tpu.metrics import porter as jporter
from cst_captioning_tpu.metrics import tokenizer as jtok
from cst_captioning_torch.metrics import evaluator as teval
from cst_captioning_torch.metrics import porter as tporter
from cst_captioning_torch.metrics import tokenizer as ttok

GTS = {
    "v0": ["A man is playing a guitar.", "someone plays the guitar",
           "a person is strumming an acoustic guitar on stage"],
    "v1": ["Two dogs run across the field!", "dogs are running",
           "a pair of puppies chase each other in the grass"],
    "v2": ["a woman is cooking pasta in a kitchen",
           "the chef boils noodles", "someone is making food"],
    "v3": ["a car drives down the road", "vehicles on a highway",
           "a red car is driving quickly"],
}

PREDICTIONS = {
    "exact": {"v0": ["a man is playing a guitar"], "v1": ["dogs are running"],
              "v2": ["the chef boils noodles"], "v3": ["a car drives down the road"]},
    "partial": {"v0": ["a man plays guitar"], "v1": ["two dogs run"],
                "v2": ["a woman is cooking"], "v3": ["a car on the road"]},
    "garbage": {"v0": ["zebra quantum"], "v1": ["purple"],
                "v2": ["x y z"], "v3": ["the the the the"]},
}

METRICS = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
           "CIDEr"]


@pytest.mark.parametrize("case", sorted(PREDICTIONS))
def test_language_eval_is_identical(case):
    res = PREDICTIONS[case]
    want = jeval.language_eval(GTS, res, metrics=METRICS, include_ciderd=True)
    got = teval.language_eval(GTS, res, metrics=METRICS, include_ciderd=True)
    assert got == want


def test_language_eval_corpus_df_on_synthetic_captions():
    rng = np.random.RandomState(0)
    words = ["cat", "dog", "runs", "jumps", "quickly", "slowly", "a", "the"]
    gts = {f"v{i}": [" ".join(rng.choice(words, rng.randint(2, 7)))
                     for _ in range(5)] for i in range(12)}
    res = {k: [" ".join(rng.choice(words, rng.randint(1, 6)))] for k in gts}
    assert (teval.language_eval(gts, res, include_ciderd=True)
            == jeval.language_eval(gts, res, include_ciderd=True))


def test_tokenizer_and_stemmer_are_identical():
    text = "He said: \"It's 3.5 o'clock -- we're LATE!\" (running, jumped)"
    assert ttok.ptb_tokenize(text) == jtok.ptb_tokenize(text)
    for w in ("running", "jumped", "happily", "generalization", "cats"):
        assert tporter.porter_stem(w) == jporter.porter_stem(w)
