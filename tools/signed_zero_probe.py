"""Which of torch's max and min ops order signed zeros as the reference
(XLA) does, on a device, and what ``windflow_tpu_torch/ops/minmax.py``
costs where they do not.

    python3 tools/signed_zero_probe.py [cuda|cpu]

For ``torch.maximum``/``torch.minimum`` (random pairs of +0, -0, +-1 and
NaN, three sizes) and ``Tensor.amax``/``Tensor.amin`` (rows of such
values, or of zeros alone, at the mesh forms' shapes and small edge
shapes, along the axis each path reduces), the number of results whose
bits differ from a numpy oracle of XLA's rule (a total order of the
bits in which -0 sorts below +0; NaN propagates), for torch's op and
for the module's form of it.  The module's forms must differ nowhere
(the script fails otherwise); they are run on the CPU as well.  On
CUDA, the wall ms a call of ``amax``/``amin`` and of the module's forms
at the mesh forms' shapes (CUDA events over 200 calls).  The last line
is a JSON object of torch's mismatch counts.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from windflow_tpu_torch.ops import minmax  # noqa: E402

# (shape, axis): compute_wmr's stripes and their shard axis, the ring's
# panes, and edges (two elements, one long row, odd sizes, either axis)
REDUCE_SHAPES = [((64, 4, 8, 1024), -1), ((64, 4, 8), 1),
                 ((64, 16, 4, 8), -1), ((64, 16, 8, 4), -1), ((3, 40), 1),
                 ((40, 3), 0), ((1 << 20,), 0), ((7, 33, 5), 1),
                 ((2, 2), 1), ((2, 2), 0), ((4096, 2), 1), ((2, 4096), 0)]
TIMED_SHAPES = [((64, 4, 8, 1024), -1), ((64, 4, 8), 1),
                ((64, 16, 4, 8), -1)]


def order_key(x):
    b = x.astype(np.float32).view(np.uint32).astype(np.int64)
    return np.where(b >> 31, -(b & 0x7FFFFFFF) - 1, b)


def oracle_reduce(x, axis, is_max):
    k = order_key(x)
    idx = (k.argmax if is_max else k.argmin)(axis=axis)
    out = np.take_along_axis(x, np.expand_dims(idx, axis), axis)
    return np.where(np.isnan(x).any(axis), np.float32(np.nan),
                    out.squeeze(axis))


def oracle_pair(a, b, is_max):
    ka, kb = order_key(a), order_key(b)
    out = np.where(ka >= kb if is_max else ka <= kb, a, b)
    return np.where(np.isnan(a) | np.isnan(b), np.float32(np.nan), out)


def mismatches(got, want) -> int:
    got = np.asarray(got, np.float32)
    nan = np.isnan(got) & np.isnan(want)
    return int(((got.view(np.uint32) != want.view(np.uint32)) & ~nan).sum())


def draw(rng, shape, zeros_only=False):
    x = np.where(rng.random(shape) < 0.5, np.float32(0.0),
                 np.float32(-0.0)).astype(np.float32)
    if not zeros_only:
        m = rng.random(shape)
        x[m < 0.05] = -1.0
        x[(m >= 0.05) & (m < 0.1)] = 1.0
        x[m > 0.9995] = np.nan
    return x


def wall_ms(fn, reps=200) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def main() -> int:
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if dev == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {dev}")
    rng = np.random.default_rng(0)
    res = {}
    for shape, axis in REDUCE_SHAPES:
        # mixed rows, rows of zeros alone, rows of -0 alone
        for case in range(3):
            x = draw(rng, shape, zeros_only=case > 0)
            if case == 2:
                x = np.full(shape, -0.0, np.float32)
            for name, is_max in (("amax", True), ("amin", False)):
                want = oracle_reduce(x, axis, is_max)
                t = torch.from_numpy(x)
                r = res.setdefault(f"{name} {shape} axis {axis}", [0, 0, 0])
                r[0] += mismatches(getattr(t.to(dev), name)(axis).cpu(),
                                   want)
                r[1] += mismatches(getattr(minmax, name)(t.to(dev),
                                                         axis).cpu(), want)
                r[1] += mismatches(getattr(minmax, name)(t, axis), want)
                r[2] += want.size
    for n in (2, 1000, 1 << 20):
        for _ in range(3):
            a, b = draw(rng, n), draw(rng, n)
            ta, tb = torch.from_numpy(a), torch.from_numpy(b)
            for name, is_max in (("maximum", True), ("minimum", False)):
                want = oracle_pair(a, b, is_max)
                r = res.setdefault(f"{name} n={n}", [0, 0, 0])
                r[0] += mismatches(getattr(torch, name)(
                    ta.to(dev), tb.to(dev)).cpu(), want)
                r[1] += mismatches(getattr(minmax, name)(
                    ta.to(dev), tb.to(dev)).cpu(), want)
                r[1] += mismatches(getattr(minmax, name)(ta, tb), want)
                r[2] += n
    for k, (raw, mod, size) in res.items():
        print(f"{k}: torch {raw}, minmax {mod} of {size} results differ")
    if dev == "cuda":
        for shape, axis in TIMED_SHAPES:
            t = torch.randn(shape, device="cuda")
            for name in ("amax", "amin"):
                raw = wall_ms(lambda: getattr(t, name)(axis))
                mod = wall_ms(lambda: getattr(minmax, name)(t, axis))
                print(f"wall {name} {shape} axis {axis}: torch "
                      f"{raw:.5f} ms, minmax {mod:.5f} ms a call")
    print(json.dumps({k: v[0] for k, v in res.items()}))
    return 1 if any(v[1] for v in res.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
