"""The eight pixel-sampler variants of the reference, re-designed as
pure deterministic streams.

The reference ships 8 `Sampler` components (reference
app/Components/Samplers/*.{hpp,cpp}) that differ along two axes:

* *value sequence*: constant 0.5 / stratified lattice / (2)-Halton /
  MersenneTwister / PCG;
* *plumbing*: per-draw generation vs a global 2^20-entry precomputed
  array (`Static*`) advanced by a relaxed atomic cursor masked with
  `ArrayMask` 0xFFFFF (reference app/MobileRT/Sampler.hpp:58-63,
  app/MobileRT/Utils/Constants.hpp:66-79).

The atomic-counter plumbing has no counterpart here: the draw order there is
whatever thread-claim order the OS produced, i.e. an *arbitrary*
assignment of stream indices to pixels.  We keep the value sequences
exactly and replace the arbitrary assignment with the canonical
deterministic one — stream index = pixel id, two consecutive draws per
pixel (u then v), a new pass of `domain` draws per sample index — which
makes every variant reproducible by construction and invariant under
sharding/device count (SURVEY.md §2.2 Samplers).

Variants ("pixel_sampler" names accepted by RenderConfig):

name               reference                          value stream
-----------------  ---------------------------------  -------------------------
constant           Constant.cpp:9-11                  fixed 0.5 (spp==1 center)
stratified         Stratified.cpp:10-19               index / domainSize
haltonseq          HaltonSeq.cpp:10-19                haltonSequence(index, 2)
mersenne           MersenneTwister.cpp:5-12           per-draw true RNG -> threefry
pcg                PCG.cpp:6-13                       per-draw true RNG -> PCG-RXS-M-XS-32
static_haltonseq   StaticHaltonSeq.cpp + Utils.hpp:210-218  shuffled Halton 2^20 array + cursor
static_mersenne    StaticMersenneTwister.cpp + Utils.hpp:230-235  MT19937-filled array + cursor
static_pcg         StaticPCG.cpp + Utils.hpp:247-252  PCG-filled array + cursor

`stratified`/`haltonseq` keep the reference's *work-queue exhaustion*
semantics: each sample pass owns `domainSize` draws, requests past the
budget return 1.0F (Stratified.cpp:12-15) — with two draws per pixel the
second half of the domain exhausts, exactly as the reference's shared
counter does.

The `Static*` fills mirror the reference's generators faithfully:
numpy's `RandomState` IS MT19937 (the reference's `std::mt19937`,
Utils.hpp:230-235) and numpy's `default_rng` IS PCG64 (the reference
uses pcg32, Utils.hpp:247-252); the reference seeds from
`std::random_device` so the exact fill is irreproducible even between
two runs of the reference itself — we pin seed 0 for reproducibility.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from . import sampling

ARRAY_MASK = 0xFFFFF          # reference Utils/Constants.hpp:70
ARRAY_SIZE = ARRAY_MASK + 1   # reference Utils/Constants.hpp:79

SAMPLER_NAMES = (
    "constant", "stratified", "haltonseq", "mersenne", "pcg",
    "static_haltonseq", "static_mersenne", "static_pcg",
)


def _halton_base2_np(index: np.ndarray) -> np.ndarray:
    """Vectorized base-2 Halton (radical inverse), matching the reference
    haltonSequence (reference app/MobileRT/Utils/Utils.cpp:43-53)."""
    idx = index.astype(np.uint64)
    value = np.zeros(idx.shape, np.float64)
    fraction = np.ones(idx.shape, np.float64)
    for _ in range(32):
        active = idx > 0
        fraction = np.where(active, fraction / 2.0, fraction)
        value = np.where(active, value + fraction * (idx & 1), value)
        idx = idx >> 1
    return value.astype(np.float32)


@lru_cache(maxsize=None)
def _static_array(kind: str) -> np.ndarray:
    """The 2^20-entry precomputed array of the Static* samplers
    (reference app/MobileRT/Utils/Utils.hpp:210-252), seed pinned to 0."""
    if kind == "haltonseq":
        vals = _halton_base2_np(np.arange(ARRAY_SIZE))
        np.random.RandomState(0).shuffle(vals)  # MT shuffle, Utils.hpp:215-217
        return vals
    if kind == "mersenne":  # numpy RandomState == MT19937
        return np.random.RandomState(0).random_sample(ARRAY_SIZE).astype(np.float32)
    if kind == "pcg":       # numpy default_rng == PCG64
        return np.random.default_rng(0).random(ARRAY_SIZE, np.float32)
    raise ValueError(kind)


def _pcg_rxs_m_xs_32(state: jnp.ndarray) -> jnp.ndarray:
    """One PCG-RXS-M-XS-32 output word from a uint32 state — a genuine
    member of the PCG family (O'Neill 2014 §6.3.4), all-32-bit so it runs
    natively without x64.  Stands in for the reference's pcg32
    (PCG.cpp:6-13), which is seeded from std::random_device and therefore
    defines only 'a high-quality uniform stream', not specific values."""
    state = state * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((state >> ((state >> jnp.uint32(28)) + jnp.uint32(4))) ^ state) \
        * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def _u01_from_u32(bits: jnp.ndarray) -> jnp.ndarray:
    return bits.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0)


def pixel_jitter(name: str, base_key: jax.Array, pixel_ids: jnp.ndarray,
                 sample_idx, domain_size: int) -> jnp.ndarray:
    """The two pixel-jitter draws (u, v) for each pixel of a batch.

    `domain_size` = width*height, the reference's `domainSize_`
    (Sampler.hpp ctor).  Returns (B, 2) float32 in [0, 1].
    """
    pixel_ids = jnp.asarray(pixel_ids, jnp.uint32)
    d_u = pixel_ids * 2           # draw index of the u deviation
    d_v = pixel_ids * 2 + 1       # ... and of the v deviation
    draws = jnp.stack([d_u, d_v], -1)  # (B, 2)

    if name == "constant":
        return jnp.full(draws.shape, 0.5, jnp.float32)

    if name == "stratified":
        # value = index/domainSize within this pass; past-budget draws
        # return 1.0F (Stratified.cpp:10-19).
        val = draws.astype(jnp.float32) / jnp.float32(domain_size)
        return jnp.where(draws < domain_size, val, jnp.float32(1.0))

    if name == "haltonseq":
        val = sampling.halton(draws, 2)
        return jnp.where(draws < domain_size, val, jnp.float32(1.0))

    if name == "mersenne":
        # Per-draw true RNG (MersenneTwister.cpp:5-12) -> the counter-based
        # threefry stream (the framework's canonical RNG, sampling.py).
        keys = sampling.ray_key(base_key, pixel_ids.astype(jnp.int32), sample_idx)
        jkeys = sampling.event_key(keys, 0, sampling.PURPOSE_PIXEL_JITTER)
        return jax.vmap(lambda k: jax.random.uniform(k, (2,), jnp.float32))(jkeys)

    if name == "pcg":
        seed = jnp.asarray(jax.random.key_data(base_key)).ravel()[-1].astype(jnp.uint32)
        state = (draws + jnp.uint32(sample_idx) * jnp.uint32(2 * domain_size)
                 + seed * jnp.uint32(0x9E3779B9))
        return _u01_from_u32(_pcg_rxs_m_xs_32(state))

    if name.startswith("static_"):
        table = jnp.asarray(_static_array(name[len("static_"):]))
        # Global cursor across passes: sample_.fetch_add(1) & ArrayMask
        # (Sampler.hpp:58-63) with the deterministic draw assignment.
        cursor = (jnp.uint32(sample_idx) * jnp.uint32(2 * domain_size) + draws) \
            & jnp.uint32(ARRAY_MASK)
        return table[cursor]

    raise ValueError(
        f"unknown pixel_sampler {name!r}; expected one of {SAMPLER_NAMES}")
