"""The port's threefry generator against jax.random: equal integer bits,
keys and categorical draws; float uniforms bit-equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from model_matching_tpu_torch import rng


@pytest.mark.parametrize("seed", [0, 3, 123456, 2**31 - 1])
def test_keys_split_fold_in_bits(seed):
    jk = jax.random.PRNGKey(seed)
    tk = rng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(jk, 7)).astype(np.int64),
        rng.split(tk, 7).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.fold_in(jk, 5)).astype(np.int64),
        rng.fold_in(tk, 5).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (3, 5), dtype=jnp.uint32)).astype(np.int64),
        rng.bits(tk, (3, 5)).numpy(),
    )
    assert int(jax.random.bits(jk, dtype=jnp.uint32)) == int(rng.bits(tk))
    keys = jax.random.split(jk, 9)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, dtype=jnp.uint32))(keys)
                   ).astype(np.int64),
        rng.bits_batched(rng.split(tk, 9)).numpy(),
    )
    # the mantissa construction is exact, so uniforms are bit-equal too
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (1000,))),
        rng.uniform(tk, (1000,)).numpy(),
    )


@pytest.mark.parametrize("seed", [0, 7])
def test_categorical_draws_equal(seed):
    """Gumbel noise goes through log twice, ops/fmath.log rounding as
    XLA's: the noise bit-equal, the drawn indices equal; gumbel_keys gives
    each key's own draw."""
    jk = jax.random.PRNGKey(seed)
    tk = rng.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.gumbel(jk, (4, 1000))),
        rng.gumbel(tk, (4, 1000)).numpy(),
    )
    keys = rng.split(tk, 3)
    both = rng.gumbel_keys(keys, (4, 1000))
    for i in range(3):
        assert torch.equal(both[i], rng.gumbel(keys[i], (4, 1000)))
    logits = np.random.default_rng(seed).normal(size=(64, 1024)).astype(np.float32)
    logits[3, :1000] = -np.inf  # masked rows as the sampler builds them
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(jk, logits, axis=-1)),
        rng.categorical(tk, torch.from_numpy(logits)).numpy(),
    )


@pytest.mark.parametrize("seed,num", [(0, 4), (11, 4), (2**31 - 1, 3)])
def test_batched_split_equals_vmap(seed, num):
    """split over a [B, 2] batch of keys == jax.vmap(split): the per-base
    round keys of the instance sampler (split(key, B), each split in 4)."""
    jkeys = jax.random.split(jax.random.PRNGKey(seed), 9)
    tkeys = rng.split(rng.PRNGKey(seed), 9)
    want = jax.vmap(lambda k: jax.random.split(k, num))(jkeys)
    got = rng.split(tkeys, num)
    assert got.shape == (9, num, 2) and got.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy())
    # each row is that key's own split
    np.testing.assert_array_equal(got[5].numpy(), rng.split(tkeys[5], num).numpy())


@pytest.mark.parametrize("seed", [1, 8])
def test_gumbel_rows_and_per_key_draws(seed):
    """One [1, n] draw per key, as jax.vmap of a categorical over a batch
    of keys makes them: the noise bit-equal to the port's single-key gumbel
    and to jax's, the drawn indices equal to jax's."""
    jkeys = jax.random.split(jax.random.PRNGKey(seed), 6)
    tkeys = rng.split(rng.PRNGKey(seed), 6)
    noise = rng.gumbel_rows(tkeys, 500)
    assert noise.shape == (6, 500) and noise.dtype == torch.float32
    for i in (0, 5):
        assert torch.equal(noise[i], rng.gumbel(tkeys[i], (1, 500))[0])
    want = jax.vmap(lambda k: jax.random.gumbel(k, (1, 500)))(jkeys)[:, 0]
    np.testing.assert_array_equal(noise.numpy(), np.asarray(want))
    logits = np.random.default_rng(seed).normal(size=(6, 500)).astype(np.float32)
    logits[2, :450] = -np.inf
    jdraw = jax.vmap(lambda k, l: jax.random.categorical(k, l[None], axis=-1))(
        jkeys, jnp.asarray(logits))[:, 0]
    tdraw = torch.argmax(noise + torch.from_numpy(logits), dim=-1)
    np.testing.assert_array_equal(np.asarray(jdraw), tdraw.numpy())
    with pytest.raises(ValueError, match=r"\[K, 2\]"):
        rng.gumbel_rows(tkeys[0], 4)
