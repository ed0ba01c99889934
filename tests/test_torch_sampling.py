"""Port parity: the sampling tail's threefry draws against ``jax.random``
on the same seeds and counters (CPU).  Keys, random bits and uniforms
must be equal bit for bit; categorical tokens must be equal."""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.paged import fused_sample as jax_fused_sample
from paddle_tpu_torch.inference import _threefry as tf
from paddle_tpu_torch.inference.paged import fused_sample

SEEDS = [0, 1, 123457, 2 ** 31 + 5, 2 ** 32 - 1]
CTRS = [0, 3, 1000, 2 ** 31 - 1]
TINY = float(np.finfo(np.float32).tiny)


def _jax_key(seed, ctr):
    key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                             np.int32(ctr))
    return key, np.asarray(jax.random.key_data(key)).astype(np.int64)


def _port_key(seed, ctr):
    return tf.fold_in(tf.prng_key(torch.tensor([seed], dtype=torch.int64)),
                      torch.tensor([ctr], dtype=torch.int64))


def test_prng_key_matches_jax():
    for seed in SEEDS:
        want = np.asarray(jax.random.key_data(
            jax.random.PRNGKey(np.uint32(seed)))).astype(np.int64)
        got = tf.prng_key(torch.tensor([seed], dtype=torch.int64))[0]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed):
    for ctr in CTRS:
        _key, want = _jax_key(seed, ctr)
        np.testing.assert_array_equal(_port_key(seed, ctr)[0].numpy(), want)


@pytest.mark.parametrize("vocab", [7, 128, 32000])
@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1, 99])
def test_bits_and_uniform_match_jax_bit_for_bit(seed, vocab):
    for ctr in (0, 17, 2 ** 31 - 1):
        key, _ = _jax_key(seed, ctr)
        tkey = _port_key(seed, ctr)
        bits = np.asarray(jax.random.bits(key, (vocab,), jnp.uint32))
        np.testing.assert_array_equal(tf.random_bits(tkey, vocab)[0].numpy(),
                                      bits.astype(np.int64))
        for lo in (0.0, TINY):
            want = np.asarray(jax.random.uniform(key, (vocab,), minval=lo,
                                                 maxval=1.0))
            got = tf.uniform(tkey, vocab, lo, 1.0)[0].numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


def test_gumbel_matches_jax_to_last_bits():
    key, _ = _jax_key(5, 9)
    want = np.asarray(jax.random.gumbel(key, (32000,)))
    got = tf.gumbel(_port_key(5, 9), 32000)[0].numpy()
    # same uniforms; torch's log and XLA's differ in the last bits
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("vocab", [7, 128, 32000])
def test_categorical_tokens_match_jax(vocab):
    rng = np.random.default_rng(vocab)
    for seed in (0, 41, 2 ** 32 - 1):
        logits = (3 * rng.standard_normal((16, vocab))).astype(np.float32)
        ctrs = rng.integers(0, 5000, 16).astype(np.int32)
        want = [int(jax.random.categorical(_jax_key(seed, c)[0], row))
                for c, row in zip(ctrs, logits)]
        keys = tf.fold_in(tf.prng_key(torch.full((16,), seed,
                                                 dtype=torch.int64)),
                          torch.from_numpy(ctrs.astype(np.int64)))
        got = tf.categorical(keys, torch.from_numpy(logits))
        assert got.tolist() == want


def test_fused_sample_matches_jax_fused_sample():
    """The tail as the engines call it: mixed greedy and sampled rows,
    per-row seeds, counters and temperatures."""
    rng = np.random.default_rng(3)
    logits = (2 * rng.standard_normal((8, 500))).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
    ctrs = rng.integers(0, 4096, 8).astype(np.int32)
    temps = np.array([0.7, 1.0, 1.3, 0.5, 1e-9, 2.0, 0.9, 1.1], np.float32)
    flags = np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)
    want = np.asarray(jax_fused_sample(jnp.asarray(logits), jnp.asarray(seeds),
                                       jnp.asarray(ctrs), jnp.asarray(temps),
                                       jnp.asarray(flags)))
    got = fused_sample(torch.from_numpy(logits), seeds, ctrs, temps, flags)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
