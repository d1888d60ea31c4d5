# corpus-rules: single_site
"""Twin of the reference corpus's decode_reimpl.py in the port's idioms
(line for line): the decode recurrence's patterns re-implemented
outside the allowlists, in torch spellings: ``torch.topk``, the
``repeat_interleave`` fan-out."""

import torch
import torch.nn.functional as F
from torch import topk as topk_alias

from cst_captioning_torch.constants import EOS_ID, PAD_ID


def rogue_beam_select(total, K):
    scores, flat = torch.topk(total, K)  # expect: CST-DEC-001
    return scores, flat


def rogue_beam_select_aliased(total, K):
    # reformat / alias-resistant: the rule resolves the aliased callee
    # (``from torch import topk as topk_alias``) too
    return topk_alias(total, K)  # expect: CST-DEC-001


def rogue_finish_update(tok, finished):
    return finished | (tok == EOS_ID) | (tok == PAD_ID)  # expect: CST-DEC-002


def rogue_finish_update_boolop(tok):
    return (tok == EOS_ID) or (tok == PAD_ID)  # expect: CST-DEC-002


def rogue_pad_eos_feed(tok):
    return torch.where(tok == PAD_ID, EOS_ID, tok)  # expect: CST-DEC-003


def rogue_cache_replication(cache_row, K):
    # the K-by memory regression: fanning cached decode state out per
    # beam row at admission
    return cache_row.repeat_interleave(K, dim=0)  # expect: CST-DEC-004
