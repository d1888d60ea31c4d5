"""The threefry-2x32 streams of ``jax.random`` and the Gumbel-max draw
on them: the CUDA kernel wrapper and the plain versions.

The JAX package draws its per-step multinomial tokens with
``jax.random`` (``decoding/core.py::decode_step`` sample mode): the
legacy batch stream of ``CaptionModel._sample_from_cache`` and the
row-keyed stream of the CST slot rollout (``row_sample_fn``).  Both are
threefry-2x32 (``jax_threefry_partitionable``), pure 32-bit integer
arithmetic, so the port replays them bit for bit:

* ``threefry2x32(key, (x0, x1))``: 5 x 4 rounds with the rotations
  13/15/26/6 and 17/29/16/24 and the key-schedule constant 0x1BD11BDA;
* ``fold_in(key, d) = threefry2x32(key, (0, d))``;
* ``split(key, n)[i] = threefry2x32(key, (0, i))``;
* ``random_bits(key, shape)`` at flat index c is ``y0 ^ y1`` of
  ``threefry2x32(key, (c >> 32, c & 0xFFFFFFFF))``;
* ``jax.random.categorical(key, scaled)`` is ``argmax(g + scaled)`` with
  ``g = -log(-log(u))``, ``f = bitcast_f32((bits >> 9) | 0x3f800000) - 1``
  and ``u = max(tiny, f * (1 - tiny) + tiny)`` in float32 (``1 - tiny``
  rounds to 1.0f, so ``u`` is ``f``, or ``tiny`` where ``f`` is 0).

A key is two 32-bit words, the JAX key's ``key_data``, held as Python
ints on the host; per-row keys are int64 tensors.  uint32 arithmetic is
done in int64 with ``& 0xFFFFFFFF`` after every add (a word shifted left
by at most 29 stays below 2**61), so the same :func:`threefry2x32`
serves Python ints and tensors.

The draw (:func:`threefry_sample`, plain version :func:`categorical_ref`)
takes decode-step logits already divided by the temperature (``scaled``
(G, V) float32) in one of two stream modes:

* row-keyed (``base``, ``row_id``, ``step``): row g's key is
  ``fold_in(fold_in(base, row_id[g]), step[g])`` and the counter is the
  column, ``jax.vmap(jax.random.categorical)`` on those keys;
* batch (``key``): one key for all rows, the counter ``g * V + v``,
  ``jax.random.categorical(key, scaled)``.

Rows with ``is_sample`` False take ``argmax(scaled)`` instead (the CST
greedy-baseline rows).  Ties go to the lowest index, as ``jnp.argmax``.
Both return ``(token (G,) int64, log_softmax(scaled)[token] (G,)
float32)``.  Masked columns (``-1e30 / T``) never win: the noise lies in
[-4.48, 15.95] (``u`` is at least ``tiny`` and below 1), unlike the
hash-Gumbel stream of the fused sampler, whose ``u`` can round to 1.

CPU tensors take :func:`categorical_ref`; CUDA tensors launch the kernel
(``csrc/threefry_sample.cu``; ``threefry_sample.launches`` counts the
launches) or raise.  No TPU kernel is replaced: the reference leaves the
draw to XLA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from cst_captioning_torch.ops import _build

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny

Key = Tuple[int, int]


def key_words(key) -> Key:
    """Two 32-bit words from a key given as two ints (a JAX key's
    ``key_data``: a tuple, an array or a tensor)."""
    k0, k1 = (int(x) & MASK32 for x in key)
    return k0, k1


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key``.
    Keys and counters are uint32 words as Python ints or int64 tensors
    (broadcasting); returns the two output words the same way."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def fold_in(key, data):
    """``jax.random.fold_in``: ``data`` a Python int (returns a key of two
    ints) or an int64 tensor of them (returns two word tensors)."""
    return threefry2x32(key, 0, data & MASK32)


def split(key, n: int = 2) -> list:
    """``jax.random.split(key, n)`` as ``n`` keys of two Python ints."""
    key = key_words(key)
    return [threefry2x32(key, 0, i) for i in range(n)]


def _counter_bits(key, counter: torch.Tensor) -> torch.Tensor:
    """``y0 ^ y1`` of threefry at the 64-bit flat ``counter`` (int64)."""
    y0, y1 = threefry2x32(key, counter >> 32, counter & MASK32)
    return y0 ^ y1


def random_bits(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _counter_bits(key_words(key), idx).reshape(tuple(shape))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 ``u`` of ``jax.random.uniform(minval=tiny, maxval=1)``
    from its uint32 ``bits`` (held in int64)."""
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    # f * (1 - tiny) + tiny with 1 - tiny rounded to 1.0f, then the max.
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 Gumbel noise of ``jax.random.gumbel`` (mode "low") from
    its uint32 ``bits``.  ``u`` is bitwise JAX's; the two logs may differ
    from XLA's in the last bit, which moves a token only on a near-tie.
    On a CPU tensor the process's first log is settled first
    (:func:`_settle_cpu_log`)."""
    u = uniform_from_bits(bits)
    if u.device.type == "cpu":
        _settle_cpu_log()
    return -torch.log(-torch.log(u))


@functools.lru_cache(maxsize=None)
def _settle_cpu_log() -> None:
    """One serial float32 log before the first parallel one.  torch's
    CPU log hands the chunks of a large tensor to MKL's vector log on
    several OpenMP threads at once, and the first such call of a process
    sometimes computes chunks with a less accurate log: relative error
    1e-4 near ``u`` = 1, so Gumbel noise up to 1e-4 off, where every
    later call is within an ulp.  A call below the parallel grain size
    runs on one thread and settles it."""
    torch.log(torch.linspace(0.5, 1.5, 256))


def row_keys(base, row_id: torch.Tensor, step: torch.Tensor):
    """Per-row keys ``fold_in(fold_in(base, row_id), step)`` as two int64
    word tensors (``row_sample_fn``'s keys)."""
    k = fold_in(key_words(base), row_id.long())
    return fold_in(k, step.long())


def _check(scaled: torch.Tensor, key, base, row_id, step, is_sample):
    if scaled.dim() != 2 or scaled.dtype != torch.float32:
        raise ValueError(f"threefry_sample: scaled must be (G, V) float32, "
                         f"got {scaled.dtype}{tuple(scaled.shape)}")
    G = scaled.shape[0]
    if (key is None) == (base is None):
        raise ValueError("threefry_sample: give either key (batch stream) "
                         "or base with row_id and step (row-keyed stream)")
    if base is not None and (row_id is None or step is None
                             or row_id.shape != (G,) or step.shape != (G,)):
        raise ValueError("threefry_sample: the row-keyed stream needs row_id "
                         "and step of shape (G,)")
    if is_sample is not None and is_sample.shape != (G,):
        raise ValueError("threefry_sample: is_sample must be (G,)")


def categorical_ref(scaled: torch.Tensor, *, key=None, base=None,
                    row_id: Optional[torch.Tensor] = None,
                    step: Optional[torch.Tensor] = None,
                    is_sample: Optional[torch.Tensor] = None):
    """Plain version (any device); see the module doc for the modes.
    Returns ``(token (G,) int64, log_softmax(scaled)[token] float32)``."""
    _check(scaled, key, base, row_id, step, is_sample)
    G, V = scaled.shape
    dev = scaled.device
    cols = torch.arange(V, dtype=torch.int64, device=dev)
    if base is not None:
        r0, r1 = row_keys(base, row_id.to(dev), step.to(dev))
        bits = _counter_bits((r0[:, None], r1[:, None]), cols[None, :])
    else:
        rows = torch.arange(G, dtype=torch.int64, device=dev)
        bits = _counter_bits(key_words(key), rows[:, None] * V + cols[None, :])
    tok = torch.argmax(gumbel_from_bits(bits) + scaled, dim=-1)
    if is_sample is not None:
        tok = torch.where(is_sample.to(dev), tok, torch.argmax(scaled, dim=-1))
    logp = torch.log_softmax(scaled, dim=-1)
    return tok, torch.gather(logp, -1, tok[:, None])[:, 0]


def threefry_sample(scaled: torch.Tensor, *, key=None, base=None,
                    row_id: Optional[torch.Tensor] = None,
                    step: Optional[torch.Tensor] = None,
                    is_sample: Optional[torch.Tensor] = None):
    """The draw of :func:`categorical_ref`, one kernel launch a call on
    CUDA tensors (``row_id`` / ``step`` any integer dtype, ``is_sample``
    bool, all on the logits' device)."""
    if scaled.device.type == "cpu":
        return categorical_ref(scaled, key=key, base=base, row_id=row_id,
                               step=step, is_sample=is_sample)
    if scaled.device.type != "cuda":
        raise ValueError(f"threefry_sample: unsupported device {scaled.device}")
    _check(scaled, key, base, row_id, step, is_sample)
    for name, x in (("row_id", row_id), ("step", step),
                    ("is_sample", is_sample)):
        if x is not None and x.device != scaled.device:
            raise ValueError(f"threefry_sample: {name} on {x.device}, "
                             f"scaled on {scaled.device}")
    G, V = scaled.shape
    tok = torch.empty((G,), dtype=torch.int64, device=scaled.device)
    tok_lp = torch.empty((G,), dtype=torch.float32, device=scaled.device)
    if G:
        x = scaled if scaled.stride(-1) == 1 else scaled.contiguous()
        row_keyed = base is not None
        k0, k1 = key_words(base if row_keyed else key)
        rid = row_id.to(torch.int32).contiguous() if row_keyed else None
        stp = step.to(torch.int32).contiguous() if row_keyed else None
        smp = (None if is_sample is None
               else is_sample.to(torch.uint8).contiguous())
        lib = _bound()
        err = lib.cst_threefry_sample(
            x.data_ptr(), x.stride(0), G, V, k0, k1, int(row_keyed),
            None if rid is None else rid.data_ptr(),
            None if stp is None else stp.data_ptr(),
            None if smp is None else smp.data_ptr(),
            tok.data_ptr(), tok_lp.data_ptr(),
            torch.cuda.current_stream(scaled.device).cuda_stream)
        _build.check(lib, err, "threefry_sample")
        _build.count_launch(threefry_sample)
    return tok, tok_lp


threefry_sample.launches = 0
_lib: Optional[ctypes.CDLL] = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("threefry_sample")
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.cst_threefry_sample.argtypes = [P, ctypes.c_longlong, I, I, U, U,
                                            I, P, P, P, P, P, P]
        lib.cst_threefry_sample.restype = I
        _lib = lib
    return _lib
