# corpus-rules: rng
"""Twin of the reference corpus's rng/rng_bad.py in the port's idioms
(line for line, ``ops/threefry.py``'s keys): key reuse (straight-line and
loop), untracked entropy (a wall-clock key root, a free-name key), token
draws outside the row-keyed allowlist — and the negative cases (split
chains, fold_in loops, branch arms, module-level roots)."""

import time

from cst_captioning_torch.ops import threefry


def bad_double_draw(key, shape):
    a = threefry.random_bits(key, shape)
    b = threefry.random_bits(key, shape)  # expect: CST-RNG-001
    return a + b


def bad_loop_reuse(key, xs):
    out = []
    for x in xs:
        out.append(threefry.random_bits(key, (4,)) + x)  # expect: CST-RNG-001
    return out


def bad_wallclock_seed(shape):
    key = threefry.key_words((int(time.time()), 0))  # expect: CST-RNG-002
    return threefry.random_bits(key, shape)


def bad_untracked_key(shape):
    # `mystery_key` is bound nowhere: not a parameter, enclosing
    # scope, module global, or import.
    return threefry.random_bits(mystery_key, shape)  # expect: CST-RNG-002


def bad_rollout_draw(key, logits):
    # token sampling outside decoding/core.py's row-keyed machinery
    return threefry.categorical_ref(logits, key=key)  # expect: CST-RNG-003


def bad_vmapped_rollout(keys, logits):
    return threefry.threefry_sample(logits, key=keys)  # expect: CST-RNG-003


# --------------------------------------------------------------------
# NEGATIVE cases: the idiomatic shapes every real call site uses.


def ok_split_chain(key, shape):
    k1, k2 = threefry.split(key)
    return threefry.random_bits(k1, shape) + threefry.random_bits(k2, shape)


def ok_fold_in_loop(key, xs):
    out = []
    for i, x in enumerate(xs):
        k = threefry.fold_in(key, i)
        out.append(threefry.random_bits(k, (4,)) + x)
    return out


def ok_branch_arms(key, shape, flag):
    # mutually exclusive arms: one consumption per execution
    if flag:
        return threefry.random_bits(key, shape)
    else:
        return threefry.random_bits(key, shape)


GLOBAL_ROOT = threefry.key_words((0, 0))


def ok_module_level_root(shape):
    # a deterministic module-level root is tracked entropy
    return threefry.random_bits(GLOBAL_ROOT, shape)


def ok_closure_key(key):
    def inner(shape):
        # closure read of the enclosing function's parameter
        return threefry.random_bits(key, shape)

    return inner


def ok_rederived_key(key, shape):
    a = threefry.random_bits(key, shape)
    key = threefry.split(key)[0]
    b = threefry.random_bits(key, shape)   # fresh binding: no reuse
    return a + b
