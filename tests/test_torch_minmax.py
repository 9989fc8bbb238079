"""``windflow_tpu_torch/ops/minmax.py`` held bit for bit against the
reference's array library on the CPU (ROADMAP C12): ``maximum`` and
``minimum`` against ``jnp.maximum``/``jnp.minimum`` (-0 below +0, NaN
propagating), ``amax``/``amin`` against ``jnp.max``/``jnp.min`` along
every axis, and ``pmax``/``pmin`` against ``lax.pmax``/``lax.pmin`` over
a mesh axis of the 8 forced host devices (tests/conftest.py), which
fold the shards in order and pass NaN over.  Torch's own ops are shown
to differ on the same inputs, so each case would catch a regression.
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from windflow_tpu_torch.ops import minmax

from torch_graphs import assert_same_bits, signed_zeros

VALUES = np.array([0.0, -0.0, np.nan, 1.0, -1.0, np.inf, -np.inf],
                  np.float32)


def _bits_differ(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a) & np.isnan(b)
    return bool((a.view(np.uint32) != b.view(np.uint32))[~nan].any())


@pytest.mark.parametrize("name", ["maximum", "minimum"])
def test_elementwise_every_pair_and_broadcast(name):
    """Every ordered pair of +0, -0, NaN, +-1, +-inf, and a column
    broadcast against a row."""
    a, b = (np.array(x, np.float32) for x in
            zip(*itertools.product(VALUES, repeat=2)))
    ref = getattr(jnp, name)
    fn = getattr(minmax, name)
    got = fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert_same_bits(got, np.asarray(ref(a, b)))
    assert _bits_differ(getattr(torch, name)(torch.from_numpy(a),
                                             torch.from_numpy(b)).numpy(),
                        np.asarray(ref(a, b)))
    col, row = VALUES[:, None], VALUES[None, :]
    assert_same_bits(fn(torch.from_numpy(col), torch.from_numpy(row)),
                     np.asarray(ref(col, row)))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("name", ["amax", "amin"])
def test_reductions_along_every_axis(name, axis):
    """Rows of +0/-0 with few or many zeros and a NaN, as jnp.max and
    jnp.min reduce them."""
    kind = "max" if name == "amax" else "min"
    rng = np.random.default_rng(axis)
    x = np.concatenate([signed_zeros(rng, (6, 5, 7), kind, n_nan=2),
                        signed_zeros(rng, (6, 5, 7), kind,
                                     zero_rate=0.2)], axis=axis)
    ref = (jnp.max if kind == "max" else jnp.min)(x, axis=axis)
    got = getattr(minmax, name)(torch.from_numpy(x), axis).numpy()
    assert (np.asarray(ref) == 0).any()
    assert_same_bits(got, np.asarray(ref))
    assert _bits_differ(getattr(torch.from_numpy(x), name)(axis).numpy(),
                        np.asarray(ref))


@pytest.mark.parametrize("W", [2, 4, 8])
@pytest.mark.parametrize("name", ["pmax", "pmin"])
def test_shard_folds_match_lax_collectives(name, W):
    """Every shard row of W values drawn from +0, -0, NaN and +-1
    (all of them for W = 2, a seeded sample above), as the reference's
    lax.pmax / lax.pmin over a 'win' axis of W host devices give it."""
    vals = VALUES[:5]
    if W == 2:
        x = np.array(list(itertools.product(vals, repeat=W)), np.float32)
    else:
        x = np.random.default_rng(W).choice(vals, (256, W)).astype(
            np.float32)
    mesh = Mesh(np.array(jax.devices()[:W]), ("win",))
    coll = getattr(jax.lax, name)
    run = jax.jit(jax.shard_map(lambda v: coll(v, "win"), mesh=mesh,
                                in_specs=P(None, "win"),
                                out_specs=P(None, None), check_vma=False))
    want = np.asarray(run(jnp.asarray(x)))[:, 0]
    got = getattr(minmax, name)(torch.from_numpy(x), 1).numpy()
    assert_same_bits(got, want)
