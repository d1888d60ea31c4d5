"""Vendored pure-Python metric suite (the port's copy of the JAX
package's ``metrics/``).

Replaces the reference's ``coco-caption`` (pycocoevalcap) and ``cider``
submodules — including the two Java components (PTBTokenizer via Stanford
CoreNLP jar, METEOR via meteor-1.5.jar) which are re-implemented in Python
with an optional Java subprocess path when a JRE + jars are present.
"""

from cst_captioning_torch.metrics.tokenizer import ptb_tokenize, tokenize_corpus  # noqa: F401
from cst_captioning_torch.metrics.bleu import Bleu  # noqa: F401
from cst_captioning_torch.metrics.rouge import Rouge  # noqa: F401
from cst_captioning_torch.metrics.cider import Cider, CiderD  # noqa: F401
from cst_captioning_torch.metrics.meteor import Meteor  # noqa: F401
from cst_captioning_torch.metrics.evaluator import language_eval  # noqa: F401
