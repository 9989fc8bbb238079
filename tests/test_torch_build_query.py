"""The FFAT rebuild lane's fused build+query (flatfat_build_query in
windflow_tpu_torch/ops/cuda/flatfat_query.py) and the window-sum
kernel's extent switch, on the CPU.

* The plain version against the reference's jitted programs
  ``_ffat_program`` (XLA query) and ``_ffat_pallas_program`` (the Pallas
  query in interpret mode), windflow_tpu/ops/window_compute.py:224, :282.
* A torch emulation of the CUDA kernel's tiling -- 1,024-leaf tiles
  built in a local heap and scattered to heap indices, the tile roots
  tiled again past 2048 of them, each block's top tree rebuilt from the
  roots -- and of its split walk (ten levels loaded up front, the rest
  from the top), held bitwise against ``build_tree`` and the plain
  version.  The kernel itself is held against the plain version on the
  card (tests/test_torch_card.py, chip_smoke.py).
* ``window_sums(..., max_extent=)`` on both sides of the 32/33 switch,
  and the wrappers' refusal of malformed input.

Tolerances: exact on integer-valued data and for max/min (every partial
sum below 2^24); ``rtol=1e-5`` for add on random f32 against the
reference (both combine the same pairs in the same order, so it is
exact in practice).  The user combines no kernel builds in
(``tests/torch_graphs.py``) go through the same tests: the arithmetic
ones exact against the reference, ``logaddexp`` within ``rtol=1e-5``
(jnp's and torch's exp/log1p forms may part by an ulp a combine).  The
emulation must be bitwise (bit patterns, NaNs included) for every
combine: the kernel's claim is that it combines exactly the pairs
``build_tree`` combines.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu.ops.window_compute import (_ffat_pallas_program,
                                             _ffat_program)
from windflow_tpu_torch.ops.cuda import flatfat_query as fq
from windflow_tpu_torch.ops.cuda import window_sum as ws

from torch_graphs import (PACKAGES, USER_EXACT, USER_RTOL, left_weighted,
                          user_combines, user_values)

RTOL = 1e-5

_REF_USER, _PORT_USER = (user_combines(p) for p in PACKAGES)
# name -> (reference combine, port combine, neutral)
COMBINES = {"add": (jnp.add, torch.add, 0.0),
            "max": (jnp.maximum, torch.maximum, -np.inf),
            "min": (jnp.minimum, torch.minimum, np.inf),
            "left_weighted": (left_weighted, left_weighted, 0.0)}
# the user combines the kernels compile from their torch ops
USER = ("mul", "logaddexp", "where_max")
COMBINES.update({name: (_REF_USER[name][0], _PORT_USER[name][0],
                        _PORT_USER[name][1]) for name in USER})

# the kernel's constants (flatfat_query.cu)
TILE_LEVELS, TOP_MAX = 10, 2048
TILE = 1 << TILE_LEVELS


def _extents(rng, n, B):
    """Random extents with the edges: empty, reversed, [0, n), end = n,
    single leaves, and windows crossing tile boundaries."""
    starts = rng.integers(0, n, B)
    ends = np.minimum(starts + rng.integers(0, 3 * TILE, B), n)
    edges = [(5, 5), (9, 3), (0, n), (n - 7, n), (n - 1, n), (0, 1),
             (TILE - 3, TILE + 3), (n, n)]
    for i, (s, e) in enumerate(edges):
        starts[i], ends[i] = s, e
    return np.stack([starts, ends]).astype(np.int32)


def _leaves(rng, n, integer, name=None):
    if name in USER:
        return user_values(name, rng, n)
    return (rng.integers(0, 97, n) if integer
            else rng.normal(size=n)).astype(np.float32)


def _bits(t):
    """A float32 tensor's bit patterns: equal bits, NaNs included."""
    return t.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# the plain version against the reference programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("program", ["xla", "pallas"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "f32"])
@pytest.mark.parametrize("name", ["add", "max", "min", "left_weighted"]
                         + list(USER))
def test_plain_matches_reference_programs(name, integer, program):
    ref_c, port_c, neutral = COMBINES[name]
    rng = np.random.default_rng(60 + list(COMBINES).index(name))
    n, B = 2048, 64
    leaves = _leaves(rng, n, integer, name)
    se = _extents(rng, n, B)
    if program == "xla":
        run = _ffat_program(ref_c, neutral, n)
    else:
        run = _ffat_pallas_program(ref_c, neutral, n, B)
    want = np.asarray(run(jnp.asarray(leaves), jnp.asarray(se)))
    got = fq.flatfat_build_query_plain(torch.from_numpy(leaves),
                                       torch.from_numpy(se), port_c,
                                       neutral).numpy()
    assert got.shape == (B,)
    if name == "logaddexp":
        np.testing.assert_allclose(got, want, rtol=USER_RTOL, atol=0)
    elif integer or name != "add":
        assert USER_EXACT.get(name, True)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        fq.flatfat_build_query(torch.from_numpy(leaves),
                               torch.from_numpy(se), port_c,
                               neutral).numpy(), got)


def test_empty_window_is_zero_not_the_neutral():
    """As the reference's where(valid, out, 0): an empty max window is
    0; an extent clamped empty (past the tree) keeps the neutral."""
    leaves = torch.arange(2048, dtype=torch.float32)
    se = torch.tensor([[4, 9, 3000], [4, 2, 3100]], dtype=torch.int32)
    got = fq.flatfat_build_query(leaves, se, torch.maximum, -np.inf)
    np.testing.assert_array_equal(got.numpy(), [0.0, 0.0, -np.inf])


# ---------------------------------------------------------------------------
# the kernel's tiling, emulated
# ---------------------------------------------------------------------------

def _sweep(heap, comb, half):
    """Nodes [1, 2 half) of a local heap [.., 4 half) from their
    children, level by level (the kernel's shared-memory sweeps)."""
    while half >= 1:
        heap[..., half:2 * half] = comb(heap[..., 2 * half:4 * half:2],
                                        heap[..., 2 * half + 1:4 * half:2])
        half //= 2


def _emulate_build(leaves, comb):
    """(nodes [n], top [2m], m) as the kernel leaves them: ``nodes`` the
    scratch of inner nodes after every tiling round, ``top`` a block's
    shared top tree over the last round's m roots."""
    n = leaves.shape[0]
    nodes = torch.full((n,), float("nan"))
    m, src = n, leaves
    j = torch.arange(1, TILE)
    depth = torch.floor(torch.log2(j.double())).long()
    while True:
        m_dst = m // TILE
        tiles = src.reshape(m_dst, TILE)
        heap = torch.full((m_dst, TILE), float("nan"))
        # a thread's float4 (x, y, z, w) -> op(x, y), op(z, w)
        heap[:, TILE // 2:] = comb(tiles[:, 0::2], tiles[:, 1::2])
        _sweep(heap, comb, TILE // 4)
        # local j at depth d -> global ((m_dst + t) << d) + (j - 2^d)
        roots = m_dst + torch.arange(m_dst)
        idx = (roots[:, None] << depth[None, :]) + (j - (1 << depth))[None]
        nodes[idx.reshape(-1)] = heap[:, 1:].reshape(-1)
        m = m_dst
        src = nodes[m:2 * m]
        if m <= TOP_MAX:
            break
    top = torch.full((2 * m,), float("nan"))
    top[m:] = nodes[m:2 * m]
    _sweep(top, comb, m // 2)
    return nodes, top, m


def _emulate_walk(leaves, nodes, top, m, se, comb, neutral):
    """The kernel's walk for every window: the ten levels inside a tile
    first (leaves, then scratch nodes), combined in order, then the
    levels above from the top tree (scratch between tiling rounds)."""
    n = leaves.shape[0]
    levels = n.bit_length() - 1
    s_raw, e_raw = se[0].long(), se[1].long()
    s, e = s_raw.clamp(0, n), e_raw.clamp(0, n)
    lo, hi = s + n, e + n
    taken = []
    for k in range(TILE_LEVELS):
        src = (lambda x: leaves[(x - n).clamp(0, n - 1)]) if k == 0 else \
            (lambda x: nodes[x.clamp(0, n - 1)])
        tl = (lo < hi) & ((lo & 1) == 1)
        lv = src(lo)
        lo = torch.where(tl, lo + 1, lo)
        tr = (lo < hi) & ((hi & 1) == 1)
        hi = torch.where(tr, hi - 1, hi)
        taken.append((tl, lv, tr, src(hi)))
        lo, hi = lo >> 1, hi >> 1
    left = torch.full(s.shape, neutral)
    right = left.clone()
    for tl, lv, tr, rv in taken:
        left = torch.where(tl, comb(left, lv), left)
        right = torch.where(tr, comb(rv, right), right)

    def node(x):
        return torch.where(x < 2 * m, top[x.clamp(0, 2 * m - 1)],
                           nodes[x.clamp(0, n - 1)])

    for _ in range(TILE_LEVELS, levels + 1):
        tl = (lo < hi) & ((lo & 1) == 1)
        left = torch.where(tl, comb(left, node(lo)), left)
        lo = torch.where(tl, lo + 1, lo)
        tr = (lo < hi) & ((hi & 1) == 1)
        hi = torch.where(tr, hi - 1, hi)
        right = torch.where(tr, comb(node(hi), right), right)
        lo, hi = lo >> 1, hi >> 1
    out = torch.where(e > s, comb(left, right), torch.full_like(left,
                                                                neutral))
    return torch.where(e_raw > s_raw, out, torch.zeros_like(out))


@pytest.mark.parametrize("n", [2048, 1 << 14, 1 << 22],
                         ids=["two_tiles", "2^14", "2^22_two_rounds"])
@pytest.mark.parametrize("name", list(COMBINES))
def test_kernel_tiling_equals_build_tree_bitwise(name, n):
    """Every node the kernel builds (scratch and top) is bitwise the
    node build_tree computes, and the split walk over them is bitwise
    the plain version, for the four combines (2^22 takes two tiling
    rounds: 4096 tile roots > 2048)."""
    _ref_c, comb, neutral = COMBINES[name]
    rng = np.random.default_rng(n.bit_length())
    leaves = torch.from_numpy(_leaves(rng, n, False, name))
    tree = fq.build_tree(leaves, comb, neutral)
    nodes, top, m = _emulate_build(leaves, comb)
    assert m == (4 if n == 1 << 22 else n // TILE)
    # scratch holds the nodes at and below the tile roots, the top tree
    # the rest
    assert torch.equal(_bits(nodes[m:]), _bits(tree[m:n]))
    assert torch.equal(_bits(top[1:]), _bits(tree[1:2 * m]))
    se = torch.from_numpy(_extents(rng, n, 200))
    got = _emulate_walk(leaves, nodes, top, m, se, comb, neutral)
    want = fq.flatfat_build_query_plain(leaves, se, comb, neutral)
    assert torch.equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# the window-sum kernel's extent switch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [32, 33])
def test_window_sums_on_both_sides_of_the_switch(width):
    """Extents of exactly 32 (the thread form, the plain tile sum) and
    33 (the warp form, the plain prefix scan): the wrapper with and
    without the hint against the plain version and the float64 sum."""
    rng = np.random.default_rng(width)
    T, B = 5000, 300
    starts = rng.integers(0, T - width, B)
    ends = starts + rng.integers(0, width + 1, B)
    ends[0] = starts[0] + width
    se = torch.from_numpy(np.stack([starts, ends]).astype(np.int32))
    assert ws.form_for(width) == ("thread" if width <= 32 else "warp")
    vals = rng.integers(0, 97, T).astype(np.float32)
    c = np.concatenate([[0.0], np.cumsum(vals.astype(np.float64))])
    want = c[ends] - c[starts]
    v = torch.from_numpy(vals)
    for hint in (width, None):
        np.testing.assert_array_equal(
            ws.window_sums(v, se, max_extent=hint).numpy(), want)
    np.testing.assert_array_equal(ws.window_sums_plain(v, se).numpy(), want)


def test_form_for_takes_the_warp_form_without_a_hint():
    assert ws.form_for(None) == "warp"
    assert ws.form_for(0) == ws.form_for(2) == "thread"
    assert ws.form_for(4096) == "warp"


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _se(B=4):
    return torch.zeros((2, B), dtype=torch.int32)


@pytest.mark.parametrize("leaves,se,match", [
    (torch.zeros(2048, dtype=torch.float64), _se(), "float32"),
    (torch.zeros((2, 2048)), _se(), "1-D"),
    (torch.zeros(3000), _se(), "power of two"),
    (torch.zeros(1024), _se(), "2048"),
    (torch.zeros(2048), _se().long(), "int32"),
    (torch.zeros(2048), torch.zeros((3, 4), dtype=torch.int32), r"\[2, B\]"),
    (torch.zeros(2048), torch.zeros(8, dtype=torch.int32), r"\[2, B\]"),
    (torch.zeros(4096)[::2], _se(), "contiguous"),
], ids=["dtype", "rank", "not_pow2", "too_small", "se_dtype", "se_rows",
        "se_rank", "strided"])
def test_build_query_rejects_malformed_input(leaves, se, match):
    with pytest.raises(ValueError, match=match):
        fq.flatfat_build_query(leaves, se, torch.add, 0.0)


def test_cpu_build_query_does_not_launch_the_kernel():
    before = fq.build_query_launch_count()
    fq.flatfat_build_query(torch.zeros(2048), _se(), torch.add, 0.0)
    assert fq.build_query_launch_count() == before
