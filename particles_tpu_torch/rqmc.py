"""Randomised quasi-Monte Carlo point sets: scrambled Sobol, Halton and
Latin hypercube (PyTorch port).

Counterpart of ``particles_tpu/rqmc.py``, with the same points: the Sobol
direction numbers come from the Joe & Kuo table the JAX package ships
(``particles_tpu/data/sobol_joe_kuo.npz``, read here in place with numpy,
21201 dimensions), and the three randomisations are the same functions of
the same random words:

* ``"lms_shift"`` (the default): a random linear matrix scramble of each
  dimension's direction numbers (Matousek), then a digital shift;
* ``"shift"``: the digital shift alone;
* ``"owen"``: a nested-uniform scramble of the points (the hash-based
  construction of Laine & Karras and Burley).

Each draw is split in two: :func:`scramble_words` draws the random words
from a ``torch.Generator`` (``rb`` (d, 32) and ``shift`` (d,) for LMS,
``shift`` for the shift, ``seeds`` (d,) for Owen), and
:func:`sobol_from_words` / :func:`sobol_sorted0_from_words` are
deterministic functions of them, so that the JAX package's words give the
JAX package's points bit for bit.  32-bit words are held in int64 tensors
(torch has no popcount and only partial uint32 support).

Every bit recurrence of the JAX code (the Gray-code expansion, the LMS
product, the sorted set's cell map) is linear over GF(2), and runs here as
a few batched tensor operations: 0/1 bit tensors through one float
``matmul`` (exact, every sum is at most 32), then ``% 2``, and byte
lookup tables for the expansion (four gathers in place of 32 rounds).  The
points are ``(word >> 8) * 2^-24`` in float32, exact, clamped to
[1e-7, 1 - 1e-7]: a scrambled net keeps its one point per dyadic cell
through the conversion.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from particles_tpu_torch.utils import resolve_device

__all__ = ["MAX_SOBOL_DIM", "sobol", "sobol_sorted0", "sobol_unscrambled",
           "sobol_from_words", "sobol_sorted0_from_words", "scramble_words",
           "load_directions", "halton", "latin", "safe_generate"]

MAX_SOBOL_DIM = 21201

_BITS = 32
_MASK = (1 << _BITS) - 1
_TABLE = Path(__file__).resolve().parent.parent / "particles_tpu" / "data" \
    / "sobol_joe_kuo.npz"


# ---------------------------------------------------------------------------
# direction numbers (host numpy, once per d)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _joe_kuo_table():
    """The Joe & Kuo new-joe-kuo-6 table: primitive polynomials and initial
    m-values, read in place from the JAX package's data directory."""
    with np.load(_TABLE) as npz:
        return (np.asarray(npz["poly"], np.int64),
                np.asarray(npz["vinit"], np.int64))


@functools.lru_cache(maxsize=None)
def _direction_numbers(d):
    """(d, 32) uint32 direction numbers V_j (bit-reversed fractions),
    numpy, computed once per d: the degree-s recurrence ``v_j = v_{j-s} ^
    (v_{j-s} >> s) ^ XOR_k a_k v_{j-k}`` as 32 column steps over all
    dimensions at once."""
    if d > MAX_SOBOL_DIM:
        raise ValueError(
            f"Sobol direction-number table covers {MAX_SOBOL_DIM} "
            f"dimensions, got d={d}")
    V = np.zeros((d, _BITS), dtype=np.uint64)
    V[0] = np.uint64(1) << (np.uint64(_BITS - 1)
                            - np.arange(_BITS, dtype=np.uint64))
    if d == 1:
        return V.astype(np.uint32)
    poly, vinit = _joe_kuo_table()
    p = poly[1:d]
    s = np.array([int(x).bit_length() - 1 for x in p], np.int64)
    m = vinit[1:d].astype(np.uint64)
    rows = np.arange(1, d)
    smax = int(s.max())
    cols = np.arange(_BITS)
    init = m[:, :_BITS] << np.uint64(_BITS - 1) - np.arange(
        min(_BITS, m.shape[1]), dtype=np.uint64)
    V[1:, :init.shape[1]] = np.where(cols[:init.shape[1]] < s[:, None],
                                     init, 0)
    for j in range(1, _BITS):
        active = j >= s
        base = V[rows, np.maximum(j - s, 0)]
        val = base ^ (base >> s.astype(np.uint64))
        for k in range(1, min(j, smax)):
            coef = ((p >> np.maximum(s - k, 0)) & 1).astype(bool)
            use = active & (k < s) & coef
            val = np.where(use, val ^ V[rows, j - k], val)
        V[rows, j] = np.where(active, val, V[rows, j])
    return V.astype(np.uint32)


# ---------------------------------------------------------------------------
# GF(2) helpers on int64-held 32-bit words
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _consts(device):
    """Per-device constants, made on the device (no copy from the host):
    bit positions 0..31, byte shifts, the LMS matrices' unit diagonal and
    the mask of the MSB positions above it (row b of a word-row matrix),
    the (256, 8) bits of every byte and the 256 byte reversals."""
    c = torch.arange(_BITS, dtype=torch.int64, device=device)
    v = torch.arange(256, dtype=torch.int64, device=device)
    byte_bits = (v[:, None] >> c[:8]) & 1
    rev8 = (byte_bits << (7 - c[:8])).sum(1)
    diag = 1 << (_BITS - 1 - c)
    return {"c": c, "byte_shift": 8 * c[:4], "diag": diag,
            "above_diag": ~(diag - 1) & ~diag & _MASK,
            "byte_bits": byte_bits.to(torch.float32), "rev8": rev8}


@functools.lru_cache(maxsize=None)
def _table_base(d, device):
    """(d, 4, 1) offsets of the byte tables: 1024 i + 256 b."""
    return torch.arange(4 * d, dtype=torch.int64,
                        device=device).reshape(d, 4, 1) * 256


def _bits(w, c):
    """(..., 32) float 0/1: ``[..., k]`` is bit k of the word ``w``."""
    return ((w.unsqueeze(-1) >> c) & 1).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _direction_bits(d, device):
    """(d, 32, 32) float bits of the direction numbers on ``device``,
    ``[i, j, k]`` bit k of V[i, j]: copied from the host once per (d,
    device)."""
    V = torch.from_numpy(_direction_numbers(d).astype(np.int64)).to(device)
    return _bits(V, _consts(device)["c"])


def load_directions(d, device):
    """Move the direction numbers of d dimensions to ``device``, once: a
    later draw there copies nothing from the host (a copy that
    synchronises)."""
    _direction_bits(d, torch.device(device))


def _lms_bits(Vb, rb):
    """Bits of the LMS-scrambled direction numbers (as :func:`_bits` of
    ``Vp``): row b of each dimension's lower-triangular matrix (``rb``
    masked to MSB positions 0..b, unit diagonal) dotted with each V[j]
    over GF(2) gives bit 31 - b of Vp[j]."""
    cst = _consts(rb.device)
    rows = (rb & cst["above_diag"]) | cst["diag"]
    P = torch.matmul(_bits(rows, cst["c"]), Vb.transpose(1, 2)) % 2
    # P[i, b, j] is bit 31 - b of Vp[i, j]
    return P.flip(1).transpose(1, 2)                  # (d, j, 31 - b)


def _byte_tables(Vb):
    """(d * 1024,) int64: entry 1024 i + 256 b + v is the XOR of V[i, 8b +
    k] over the set bits k of the byte v, from the bits ``Vb`` (d, 32,
    32)."""
    cst = _consts(Vb.device)
    d = Vb.shape[0]
    Tb = torch.einsum("vk,ibkc->ibvc", cst["byte_bits"],
                      Vb.reshape(d, 4, 8, _BITS)) % 2
    return (Tb.to(torch.int64) << cst["c"]).sum(-1).reshape(-1)


def _expand(tables, start, count):
    """(d, count) int64 raw Sobol words of rows [start, start + count),
    one dimension a row: the XOR expansion at the Gray code of each index,
    a byte at a time, by one gather of 4 d count table entries (on the
    card, a gather of (count, d) int64 rows is far slower)."""
    dev = tables.device
    d = tables.shape[0] // 1024
    i = start + torch.arange(count, dtype=torch.int64, device=dev)
    gray = i ^ (i >> 1)
    idx = ((gray >> _consts(dev)["byte_shift"][:, None]) & 255) \
        + _table_base(d, dev)                           # (d, 4, count)
    t = tables.index_select(0, idx.reshape(-1)).reshape(d, 4, count)
    return t[:, 0] ^ t[:, 1] ^ t[:, 2] ^ t[:, 3]


def _bitreverse32(x):
    """The 32 bits of each word reversed, by byte table."""
    cst = _consts(x.device)
    b = (x.unsqueeze(-1) >> cst["byte_shift"]) & 255
    return (cst["rev8"][b] << (24 - cst["byte_shift"])).sum(-1)


def _mul32(x, k):
    """``x * k mod 2^32`` for words ``x`` and a constant ``k``, in int64
    without overflow (16-bit halves of x)."""
    lo = (x & 0xFFFF) * k
    hi = (((x >> 16) * k) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _owen_scramble(ints, seeds):
    """Nested-uniform (Owen) scramble of raw Sobol words (d, N) with
    per-dimension ``seeds`` (d, 1): Burley's hash in the bit-reversed domain,
    where each output digit depends only on the more significant input
    digits."""
    x = (_bitreverse32(ints) + seeds) & _MASK
    for k in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, k)
    return _bitreverse32(x)


def _to_unit(words):
    """float32 points from 32-bit words: the top 24 bits, exact, then
    clamped into (0, 1) as the JAX package clamps."""
    u = (words >> 8).to(torch.float32) * 2.0 ** -24
    return u.clamp_(1e-7, 1.0 - 1e-7)


# ---------------------------------------------------------------------------
# Sobol
# ---------------------------------------------------------------------------

def scramble_words(gen, d, scramble="lms_shift"):
    """The random words of one scrambled Sobol set, drawn from ``gen`` on
    its device as int64 in [0, 2^32): ``{"rb": (d, 32), "shift": (d,)}``
    for ``"lms_shift"``, ``{"shift": (d,)}`` for ``"shift"``, ``{"seeds":
    (d,)}`` for ``"owen"`` (the JAX package's ``jax.random.bits`` of the
    same key splits)."""
    def draw(*shape):
        return torch.randint(0, 1 << _BITS, shape, generator=gen,
                             device=gen.device, dtype=torch.int64)

    if scramble == "lms_shift":
        return {"rb": draw(d, _BITS), "shift": draw(d)}
    if scramble == "shift":
        return {"shift": draw(d)}
    if scramble == "owen":
        return {"seeds": draw(d)}
    raise ValueError(f"unknown scramble: {scramble!r}")


def _check_words(words, scramble, d):
    want = {"lms_shift": {"rb", "shift"}, "shift": {"shift"},
            "owen": {"seeds"}}.get(scramble)
    if want is None:
        raise ValueError(f"unknown scramble: {scramble!r}")
    if set(words) != want:
        raise ValueError(f"{scramble}: words {sorted(words)}, expected "
                         f"{sorted(want)}")
    for k, w in words.items():
        if w.dtype != torch.int64 or w.shape[0] != d:
            raise ValueError(f"{scramble}: words[{k!r}] must be int64 with "
                             f"leading dimension d={d}")


def sobol_from_words(words, N, d, scramble="lms_shift", start=0,
                     count=None):
    """Scrambled Sobol points (count, d) float32 in (0, 1): rows [start,
    start + count) of the N-point set (``count`` defaults to N) randomised
    by ``words`` (:func:`scramble_words`), on the words' device.  The
    result is the transpose of a (d, count) tensor: each column is
    contiguous."""
    _check_words(words, scramble, d)
    count = N if count is None else count
    dev = next(iter(words.values())).device
    Vb = _direction_bits(d, dev)
    if scramble == "lms_shift":
        Vb = _lms_bits(Vb, words["rb"])
    ints = _expand(_byte_tables(Vb), start, count)
    if scramble == "owen":
        return _to_unit(_owen_scramble(ints, words["seeds"][:, None])).T
    return _to_unit(ints ^ words["shift"][:, None]).T


def sobol(gen, N, d, scramble="lms_shift", start=0, count=None):
    """Scrambled Sobol points (N, d) in (0, 1) from ``gen`` (on its device):
    ``scramble`` is ``"lms_shift"`` (default), ``"owen"`` or ``"shift"``;
    ``start``/``count`` select rows [start, start + count) of the one
    N-point set."""
    return sobol_from_words(scramble_words(gen, d, scramble), N, d,
                            scramble, start, count)


def sobol_sorted0_from_words(words, N, d, start=0, count=None):
    """The LMS + shift Sobol set of ``words`` in the order of its first
    coordinate, rows [start, start + count).  N = 2^m <= 2^24: the first
    coordinate is a (0, m, 1)-net, one point in each dyadic cell [j/N,
    (j+1)/N), so the cell index of the top m bits is a permutation and the
    sort is its inverse, one scatter.  Bit-identical to sorting
    :func:`sobol_from_words` by its first column, ties impossible."""
    m = int(N).bit_length() - 1
    if N != (1 << m) or m > 24:
        raise ValueError("sobol_sorted0 requires N a power of 2 (<= 2^24)")
    _check_words(words, "lms_shift", d)
    Vb = _lms_bits(_direction_bits(d, words["rb"].device), words["rb"])
    ints = _expand(_byte_tables(Vb), 0, N) ^ words["shift"][:, None]
    cell = ints[0] >> (_BITS - m)
    order = torch.empty_like(cell).scatter_(
        0, cell, torch.arange(N, device=cell.device))
    if start or count is not None:
        order = order[start:start + (N if count is None else count)]
    return _to_unit(torch.gather(ints, 1, order.expand(d, -1))).T


def sobol_sorted0(gen, N, d, start=0, count=None):
    """LMS + shift-scrambled Sobol points from ``gen``, sorted by the first
    coordinate (N a power of two, <= 2^24): the same draws from ``gen``
    and the same set as :func:`sobol`, rows [start, start + count) of its
    sorted order."""
    return sobol_sorted0_from_words(scramble_words(gen, d), N, d, start,
                                    count)


def sobol_unscrambled(N, d, device=None):
    """The first N deterministic Sobol points in [0, 1)^d, float32 (for
    tests and debugging), on ``device`` (default: the current CUDA
    card)."""
    ints = _expand(_byte_tables(_direction_bits(d, resolve_device(device))),
                   0, N)
    return ints.T.to(torch.float32) * 2.0 ** -_BITS


def safe_generate(N, d, engine_cls):
    """N points of a scipy-style QMC engine (``engine_cls(d).random(N)``, or
    a bare callable ``engine_cls(d)(N)``) squeezed strictly inside (0, 1)
    as the reference does (``0.5 + (1 - 1e-10) (u - 0.5)``); host numpy."""
    eng = engine_cls(d)
    u = eng.random(N) if hasattr(eng, "random") else eng(N)
    return 0.5 + (1.0 - 1e-10) * (np.asarray(u) - 0.5)


# ---------------------------------------------------------------------------
# Halton and Latin hypercube
# ---------------------------------------------------------------------------

def _first_primes(d):
    primes = []
    n = 2
    while len(primes) < d:
        if all(n % p for p in primes):
            primes.append(n)
        n += 1
    return primes


def halton(gen, N, d):
    """Randomised (shifted) Halton points (N, d) from ``gen``: the radical
    inverse of 0..N-1 in the first d primes, each column shifted by a
    uniform modulo 1."""
    dev = gen.device
    n = torch.arange(N, device=dev)
    shifts = torch.rand(d, generator=gen, device=dev)
    cols = []
    for k, b in enumerate(_first_primes(d)):
        x = torch.zeros(N, device=dev)
        ndig = int(np.ceil(np.log(max(N, 2)) / np.log(b))) + 1
        for dig in range(ndig):
            x = x + (n // (b ** dig) % b) * (1.0 / b) / (b ** dig)
        cols.append((x + shifts[k]) % 1.0)
    return torch.stack(cols, 1).clamp_(1e-7, 1.0 - 1e-7)


def latin(gen, N, d):
    """Latin hypercube sample (N, d) from ``gen``: one point in each of the
    N strata of every coordinate, the strata paired by random
    permutations."""
    dev = gen.device
    u = torch.rand(N, d, generator=gen, device=dev)
    perms = torch.rand(d, N, generator=gen, device=dev).argsort(1).T
    return ((perms + u) / N).clamp_(1e-7, 1.0 - 1e-7)
