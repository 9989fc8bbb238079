"""The port's FlatFAT query kernel (K2) and the lanes that run it, on the
card: the kernel against its plain version, the resident lanes on CUDA
against the same lanes on the CPU, one kernel launch per launched batch,
and the refusal of combines the kernel does not compile.

This file imports neither jax nor the reference package, so it runs
where the card is:

    python -m pytest -m cuda tests/test_torch_card.py

Every test is marked ``cuda`` and skips without a card.  Tolerances:
exact for max/min and for add on integer-valued data; ``rtol=1e-5`` for
the non-commutative ``left_weighted`` test combine.
"""
import numpy as np
import pytest
import torch

import windflow_tpu_torch as wf
from windflow_tpu_torch.core.tuples import TupleBatch
from windflow_tpu_torch.operators.tpu.ffat_resident import \
    WinSeqFFATResidentLogic
from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPULogic
from windflow_tpu_torch.ops.cuda import flatfat_query as fq
from windflow_tpu_torch.ops.flatfat_torch import build_tree
from windflow_tpu_torch.ops.window_compute import WindowComputeEngine

pytestmark = pytest.mark.cuda

# name -> (combine, neutral, exact)
COMBINES = {"add": (torch.add, 0.0, True),
            "max": (torch.maximum, -np.inf, True),
            "min": (torch.minimum, np.inf, True),
            "left_weighted": (fq._left_weighted, 0.0, False)}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_card.py)")


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


@pytest.mark.parametrize("name", list(COMBINES))
def test_kernel_matches_plain(name):
    """A forest query with empty, whole-row and random extents: one
    launch, equal to the plain version."""
    comb, neutral, exact = COMBINES[name]
    rng = np.random.default_rng(30)
    K, n, B = 5, 256, 300
    forest = torch.stack([build_tree(torch.from_numpy(
        rng.integers(0, 100, n).astype(np.float32)), comb, neutral)
        for _ in range(K)]).cuda()
    rows = _i32(rng.integers(0, K, B)).cuda()
    starts = rng.integers(0, n, B)
    ends = np.minimum(starts + rng.integers(0, n, B), n)
    ends[:3] = starts[:3]
    starts[3], ends[3] = 0, n
    s, e = _i32(starts).cuda(), _i32(ends).cuda()
    before = fq.launch_count()
    got = fq.flatfat_query(forest, rows, s, e, comb, neutral).cpu().numpy()
    torch.cuda.synchronize()
    assert fq.launch_count() == before + 1
    want = fq.flatfat_query_plain(forest, rows, s, e, comb,
                                  neutral).cpu().numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_non_kernel_combine_raises_naming_the_roadmap_item():
    tree = torch.zeros(16, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7b"):
        fq.flatfat_query(tree, None, _i32([0]).cuda(), _i32([4]).cuda(),
                         lambda a, b: a + b, 0.0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7b"):
        WindowComputeEngine(("ffat", torch.mul, 1.0), device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7b"):
        WinSeqFFATResidentLogic(lambda t: t.value, torch.mul, 1.0, 64, 16,
                                device="cuda")


def _run_logic(lg, n, chunk=500, n_keys=3):
    out = []
    for c in range(0, n, chunk):
        idx = np.arange(c, min(c + chunk, n))
        lg.svc(TupleBatch({"key": idx % n_keys, "id": idx // n_keys,
                           "ts": idx // n_keys,
                           "value": (idx % 7).astype(np.float64)}),
               0, out.append)
    lg.eos_flush(out.append)
    return {(r.key, r.id): (r.value, r.ts) for r in out}


@pytest.mark.parametrize("lane", ["pane", "ffat_resident", "ffat_rebuild"])
def test_lane_on_the_card_matches_the_cpu_and_launches_per_batch(lane):
    """Each lane of the kernel on CUDA against the same lane on the CPU,
    with one K2 launch per launched batch."""
    def make(device):
        if lane == "ffat_resident":
            return WinSeqFFATResidentLogic(lambda t: t.value, torch.add, 0.0,
                                           512, 16, device=device)
        kind = "sum" if lane == "pane" else ("ffat", torch.maximum, -np.inf)
        return WinSeqTPULogic(kind, 256, 32, wf.WinType.CB, batch_len=16,
                              resident=True if lane == "pane" else None,
                              value_of=lambda t: t.value, device=device)

    want = _run_logic(make("cpu"), 6000)
    lg = make("cuda")
    fq.reset_launch_count()
    got = _run_logic(lg, 6000)
    assert want and got == want
    assert fq.launch_count() == lg.launched_batches > 0
