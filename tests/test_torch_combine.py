"""User FFAT combines lowered to C++ for the FlatFAT kernels
(windflow_tpu_torch/ops/cuda/combine_lower.py) and resolved for the card
(``flatfat_query.resolve_combine``), on the CPU.

* The golden C++ body of every supported op, of the test suites'
  non-commutative ``left_weighted``, of ``torch.mul``, ``torch.logaddexp``
  and a NaN-skipping max written with ``torch.where``.
* Constants: each emitted as the exact f32 that torch rounds the Python
  scalar to.
* The ``ValueError`` of a combine that cannot be lowered: another op,
  Python control flow on a traced value, a result that is not one f32.
* Equal lambdas lower to one text and share one cache key and library;
  the builtins build nothing new; the generated source and the nvcc
  command of a user library (the build itself runs on the card:
  tests/test_torch_card.py, chip_smoke.py).
* Binding a user combine to the card resolves it there (engine, resident
  logic, forest), and an untraceable one raises ``ValueError`` at bind,
  before any data is staged.

No card is needed: nvcc is replaced by a stub where a test resolves.
"""
import operator

import numpy as np
import pytest
import torch

from windflow_tpu_torch.ops.cuda import combine_lower as cl
from windflow_tpu_torch.ops.cuda import flatfat_query as fq
from windflow_tpu_torch.runtime import build


def _left_weighted(a, b):
    return a * 0.5 + b


def _nan_skipping_max(a, b):
    return torch.where(torch.isnan(a) | (b > a), b, a)


def _one(expr):
    """The body of a combine that is one statement ``t0 = expr``."""
    return f"const float t0 = {expr}; return t0;"


# combine -> its golden body
GOLDEN = {
    "left_weighted": (_left_weighted,
                      "const float t0 = __fmul_rn(a, (0x1p-1f)); "
                      "const float t1 = __fadd_rn(t0, b); return t1;"),
    "torch.mul": (torch.mul, _one("__fmul_rn(a, b)")),
    "torch.logaddexp": (torch.logaddexp, _one(
        "((isinf(a) && a == b) ? a : __fadd_rn(fmaxf(a, b), "
        "log1pf(expf(-fabsf(__fsub_rn(a, b))))))")),
    "where": (_nan_skipping_max,
              "const bool t0 = isnan(a); const bool t1 = (b > a); "
              "const bool t2 = (t0 || t1); const float t3 = (t2 ? b : a); "
              "return t3;"),
    "add": (lambda a, b: a + b, _one("__fadd_rn(a, b)")),
    "torch.add": (lambda a, b: torch.add(a, b), _one("__fadd_rn(a, b)")),
    "sub": (lambda a, b: a - b, _one("__fsub_rn(a, b)")),
    "torch.sub": (torch.sub, _one("__fsub_rn(a, b)")),
    "rsub": (lambda a, b: 1 - b, _one("__fsub_rn((0x1p+0f), b)")),
    "mul_method": (lambda a, b: a.mul(b), _one("__fmul_rn(a, b)")),
    "div": (lambda a, b: a / b, _one("__fdiv_rn(a, b)")),
    "torch.div": (torch.div, _one("__fdiv_rn(a, b)")),
    # torch on CUDA multiplies by the divisor's f32 reciprocal
    "div_const": (lambda a, b: a / 4.0, _one("__fmul_rn(a, (0x1p-2f))")),
    "div_const3": (lambda a, b: a / 3, _one("__fmul_rn(a, (0x1.555556p-2f))")),
    # c / x is x.reciprocal() * c in torch
    "rdiv": (lambda a, b: 2.0 / a, _one("__fmul_rn(__frcp_rn(a), (0x1p+1f))")),
    "torch.div_const_first": (lambda a, b: torch.div(2.0, a),
                              _one("__fdiv_rn((0x1p+1f), a)")),
    "neg": (lambda a, b: -a, _one("(-a)")),
    "torch.neg": (lambda a, b: torch.neg(b), _one("(-b)")),
    "abs": (lambda a, b: torch.abs(a), _one("fabsf(a)")),
    "maximum": (torch.maximum, _one(
        "(isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b)))")),
    "minimum": (lambda a, b: torch.minimum(b, a), _one(
        "(isnan(b) ? b : (isnan(a) ? a : fminf(b, a)))")),
    "fmax": (torch.fmax, _one("fmaxf(a, b)")),
    "fmin": (lambda a, b: a.fmin(b), _one("fminf(a, b)")),
    "exp": (lambda a, b: torch.exp(a), _one("expf(a)")),
    "log": (lambda a, b: b.log(), _one("logf(b)")),
    "log1p": (lambda a, b: torch.log1p(a), _one("log1pf(a)")),
    "expm1": (lambda a, b: torch.expm1(a), _one("expm1f(a)")),
    "sqrt": (lambda a, b: torch.sqrt(a), _one("sqrtf(a)")),
    "clamp": (lambda a, b: torch.clamp(a, -1, 1.5), _one(
        "(isnan(a) ? a : fminf(fmaxf(a, (-0x1p+0f)), (0x1.8p+0f)))")),
    "clamp_min_kw": (lambda a, b: a.clamp(min=0.0), _one(
        "(isnan(a) ? a : fmaxf(a, (0x0p+0f)))")),
    "clamp_max": (lambda a, b: torch.clamp_max(a, 2), _one(
        "(isnan(a) ? a : fminf(a, (0x1p+1f)))")),
    "where_const": (lambda a, b: torch.where(a >= b, a, 0.0),
                    "const bool t0 = (a >= b); "
                    "const float t1 = (t0 ? a : (0x0p+0f)); return t1;"),
    "where_method": (lambda a, b: a.where(a < b, b),
                     "const bool t0 = (a < b); "
                     "const float t1 = (t0 ? a : b); return t1;"),
    "compare_ops": (lambda a, b: torch.where(
        (a == b) & ~(a != 0.5) | (a <= b), torch.gt(a, b) * 0 + a, b),
        None),
    "isinf": (lambda a, b: torch.where(torch.isinf(a), b, a),
              "const bool t0 = isinf(a); "
              "const float t1 = (t0 ? b : a); return t1;"),
    "logical": (lambda a, b: torch.where(
        torch.logical_not(torch.logical_and(a > b, torch.logical_or(
            a < 0, b < 0))), a, b), None),
    "only_b": (lambda a, b: b, "return b;"),
}


@pytest.mark.parametrize("name", [n for n, (_c, want) in GOLDEN.items()
                                  if want is not None])
def test_golden_body(name):
    combine, want = GOLDEN[name]
    assert cl.lower_combine(combine) == want


def test_comparisons_and_masks_lower_to_cpp_operators():
    body = cl.lower_combine(GOLDEN["logical"][0])
    for text in ("(a > b)", "(a < (0x0p+0f))", "(b < (0x0p+0f))", "||",
                 "&&", "(!t"):
        assert text in body
    with pytest.raises(ValueError, match="mask"):
        # a comparison result multiplied like a number: not lowered
        cl.lower_combine(GOLDEN["compare_ops"][0])
    body = cl.lower_combine(lambda a, b: torch.where(
        (a == b) | (a != 0.5) | torch.ge(a, b) | torch.le(a, b)
        | torch.lt(a, b) | torch.eq(a, b) | torch.ne(a, b), a, b))
    for op in ("==", "!=", ">=", "<=", "<"):
        assert f" {op} " in body


@pytest.mark.parametrize("value", [0.1, 1 / 3, 2, 16777217, 1e-45, -0.0,
                                   3.4e38, 1e39, -1e39, float("inf"),
                                   -float("inf"), float("nan")])
def test_constants_are_the_exact_f32_torch_rounds_to(value):
    """The literal is the f32 that torch rounds the Python scalar to:
    parsed back (hex float, or the bit pattern of a non-finite), it is
    bitwise ``torch.tensor(value, dtype=float32)``."""
    lit = cl.f32_literal(value)
    want = torch.tensor(value, dtype=torch.float32).numpy()
    if lit.startswith("__uint_as_float("):
        bits = int(lit[len("__uint_as_float("):-2], 16)
        got = np.array(bits, np.uint32).view(np.float32)
    else:
        assert lit.startswith("(") and lit.endswith("f)")
        got = np.float32(float.fromhex(lit[1:-2]))
    assert got.tobytes() == want.tobytes(), (lit, got, want)


def test_constant_in_a_combine_is_rounded_once_to_f32():
    body = cl.lower_combine(lambda a, b: a * 0.1 + b)
    assert "(0x1.99999ap-4f)" in body  # float32(0.1), not the double


@pytest.mark.parametrize("combine,match", [
    (lambda a, b: torch.sin(a), "the op .*sin"),
    (lambda a, b: a ** 2, "the op pow"),
    (lambda a, b: a.sum(), "the method Tensor.sum"),
    (lambda a, b: torch.add(a, b, alpha=2), "alpha"),
    (lambda a, b: torch.div(a, b, rounding_mode="floor"), "rounding_mode"),
    (lambda a, b: torch.clamp(a, b), "not a Python constant"),
    (lambda a, b: a + torch.ones(1), "captured"),
    (lambda a, b: torch.maximum(a, torch.tensor(0.0)), "captured"),
    (lambda a, b: a & b, "not a mask"),
    (lambda a, b: torch.where(a, a, b), "not a mask"),
], ids=["sin", "pow", "sum", "alpha", "rounding_mode", "clamp_tensor",
        "tensor_constant", "tensor_constant_max", "and_on_floats",
        "where_float_condition"])
def test_unsupported_op_raises_naming_it_and_the_set(combine, match):
    with pytest.raises(ValueError, match=match) as e:
        cl.lower_combine(combine)
    assert "torch.logaddexp" in str(e.value)  # the supported set


def test_control_flow_on_a_traced_value_raises():
    def branchy(a, b):
        return a if a > b else b

    with pytest.raises(ValueError, match="control flow"):
        cl.lower_combine(branchy)


@pytest.mark.parametrize("combine", [
    lambda a, b: (a, b), lambda a, b: 1.0, lambda a, b: a > b,
    lambda a, b: torch.isnan(a)], ids=["tuple", "constant", "mask",
                                       "isnan"])
def test_non_scalar_result_raises(combine):
    with pytest.raises(ValueError, match="result"):
        cl.lower_combine(combine)


def test_wrong_arity_and_non_callable_raise():
    with pytest.raises(ValueError, match="tracing failed"):
        cl.lower_combine(lambda a: a)
    with pytest.raises(ValueError, match="not a callable"):
        cl.lower_combine(3.0)


def test_equal_lambdas_share_one_cache_key():
    f = lambda a, b: a * 0.5 + b  # noqa: E731
    g = lambda x, y: x * 0.5 + y  # noqa: E731
    assert f is not g
    assert cl.lower_combine(f) == cl.lower_combine(g) \
        == cl.lower_combine(_left_weighted)
    assert cl.combine_key(cl.lower_combine(f)) == \
        cl.combine_key(cl.lower_combine(g))
    assert cl.combine_key(cl.lower_combine(f)) != \
        cl.combine_key(cl.lower_combine(lambda a, b: a * 0.25 + b))
    # dead code does not change the key
    assert cl.lower_combine(lambda a, b: (a - b, a * 0.5 + b)[1]) \
        == cl.lower_combine(f)


# ---------------------------------------------------------------------------
# resolution: the builtins, the generated library, bind time
# ---------------------------------------------------------------------------

@pytest.fixture
def stub_nvcc(monkeypatch, tmp_path):
    """Builds recorded instead of run: build_shared writes nothing and
    returns a name; ctypes loading is replaced by a record."""
    builds = []

    def fake_build(name, cmd, srcs, timeout=600.0):
        builds.append((name, list(cmd), list(srcs)))
        return str(tmp_path / name)

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(fq, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(fq, "build_shared", fake_build)
    monkeypatch.setattr(fq, "nvcc_command", lambda src, include_dirs=(): [
        "nvcc", *[f"-I{d}" for d in include_dirs], "-o", build.OUT, src])
    monkeypatch.setattr(fq, "_bind", lambda path: ("lib", path))
    monkeypatch.setattr(fq, "_lib", None)
    monkeypatch.setattr(fq, "_user_libs", {})
    monkeypatch.setattr(fq, "_user_lib_locks", {})
    monkeypatch.setattr(fq, "_resolved", {})
    return builds


def test_builtins_keep_their_op_codes_and_build_nothing_new(stub_nvcc):
    for combine, code in ((torch.add, 0), (torch.maximum, 1),
                          (torch.minimum, 2), ("sum", 0), ("count", 0),
                          ("max", 1), ("min", 2)):
        k = fq.resolve_combine(combine)
        assert (k.code, k.user) == (code, False)
        assert k.fn is fq.torch_combine(combine)
    assert [b[0] for b in stub_nvcc] == ["libwf_flatfat_query.so"]
    assert fq.builtin_op(torch.mul) is None
    assert fq.builtin_op(lambda a, b: a + b) is None  # a user combine


def test_user_combine_builds_one_library_per_lowered_body(stub_nvcc):
    f = lambda a, b: a * 0.5 + b  # noqa: E731
    g = lambda x, y: x * 0.5 + y  # noqa: E731
    kf, kg = fq.resolve_combine(f), fq.resolve_combine(g)
    assert kf.user and kf.code == fq.USER_OP and kf.fn is f
    assert kf.lib is kg.lib and len(stub_nvcc) == 1
    assert fq.resolve_combine(f) is kf  # cached by the callable
    assert fq.resolve_combine(kf) is kf  # a resolved combine passes
    name, cmd, srcs = stub_nvcc[0]
    key = cl.combine_key(cl.lower_combine(f))
    assert name == f"libwf_flatfat_query_{key}.so"
    gen = srcs[1]
    assert srcs[0] == fq._SRC and gen.endswith(f"wf_flatfat_query_{key}.cu")
    with open(gen) as fh:
        text = fh.read()
    assert text == fq.user_source(cl.lower_combine(f))
    assert f"#define WF_USER_COMBINE_BODY {cl.lower_combine(f)}\n" in text
    assert '#include "flatfat_query.cu"' in text
    assert cmd[-1] == gen and f"-I{fq.os.path.dirname(fq._SRC)}" in cmd
    fq.resolve_combine(torch.logaddexp)
    assert len(stub_nvcc) == 2  # another body, another library


def test_the_cuda_source_holds_the_user_op_code():
    """The source compiles UserOp in under WF_USER_COMBINE_BODY with op
    code 3 (fq.USER_OP), and only the builtins without it."""
    with open(fq._SRC) as fh:
        src = fh.read()
    assert "#ifdef WF_USER_COMBINE_BODY" in src
    assert f"case {fq.USER_OP}:\n      return fn(UserOp{{}});" in src
    assert "WF_USER_COMBINE_BODY\n  }" in src  # the functor's body
    assert src.count("with_op(op,") == 3  # the three entries


def test_untraceable_combine_raises_before_any_build(stub_nvcc):
    with pytest.raises(ValueError, match="control flow"):
        fq.resolve_combine(lambda a, b: a if a > b else b)
    assert stub_nvcc == []


def _fake_card(monkeypatch, *modules):
    """resolve_device answers CUDA without a card, so a bind takes the
    card's branch up to its first CUDA call."""
    def resolve(device):
        return torch.device(device)

    for m in modules:
        monkeypatch.setattr(m, "resolve_device", resolve)


def test_engine_bind_resolves_the_user_combine(stub_nvcc, monkeypatch):
    from windflow_tpu_torch.ops import window_compute as wc
    _fake_card(monkeypatch, wc)
    eng = wc.WindowComputeEngine(("ffat", torch.logaddexp, -np.inf))
    assert not stub_nvcc  # nothing built before the bind
    eng.bind("cuda")
    assert eng._ffat_combine.user and len(stub_nvcc) == 1
    # replicas of one combine share the build
    wc.WindowComputeEngine(("ffat", torch.logaddexp, -np.inf)).bind("cuda")
    assert len(stub_nvcc) == 1
    with pytest.raises(ValueError, match="control flow"):
        wc.WindowComputeEngine(
            ("ffat", lambda a, b: a if a > b else b, 0.0)).bind("cuda")
    # the CPU keeps the callable as given, resolving nothing
    cpu = wc.WindowComputeEngine(("ffat", torch.sin, 0.0), device="cpu")
    assert cpu._ffat_combine is torch.sin and len(stub_nvcc) == 1


def test_resident_set_device_raises_at_bind(stub_nvcc, monkeypatch):
    from windflow_tpu_torch.operators.tpu import ffat_resident as fr
    _fake_card(monkeypatch, fr)
    lg = fr.WinSeqFFATResidentLogic(lambda t: t.value,
                                    lambda a, b: a if a > b else b, 0.0,
                                    64, 16)
    with pytest.raises(ValueError, match="control flow"):
        lg.set_device("cuda")
    assert lg.device is None and stub_nvcc == []


def test_forest_construction_resolves_on_the_card_only(stub_nvcc,
                                                       monkeypatch):
    from windflow_tpu_torch.ops import flatfat_torch as ft
    cpu = ft.BatchedFlatFAT(torch.logaddexp, -np.inf, 2, 16, device="cpu")
    assert cpu.combine is torch.logaddexp and not stub_nvcc
    _fake_card(monkeypatch, ft)
    with pytest.raises(ValueError, match="the op"):
        ft.FlatFATTorch(lambda a, b: torch.sin(a), 0.0, 16, device="cuda")
    with pytest.raises(ValueError, match="control flow"):
        ft.BatchedFlatFAT(lambda a, b: a if a > b else b, 0.0, 2, 16,
                          device="cuda")
    assert stub_nvcc == []


def test_user_launches_are_counted_apart(monkeypatch):
    for name in ("_launches", "_fused_launches", "_build_query_launches"):
        monkeypatch.setattr(fq, name, 0)
    monkeypatch.setattr(fq, "_user_launches", dict(fq._user_launches))
    fq.reset_user_launch_counts()
    assert fq.user_launch_counts() == dict.fromkeys(
        ("flatfat_query", "flatfat_update_query", "flatfat_build_query"), 0)
    before = (fq.launch_count(), fq.build_query_launch_count())
    user = fq.KernelCombine(operator.mul, None, fq.USER_OP, True)
    builtin = fq.KernelCombine(torch.add, None, 0, False)
    fq._counted("flatfat_query", user)
    fq._counted("flatfat_build_query", builtin)
    assert fq.user_launch_counts()["flatfat_query"] == 1
    assert fq.user_launch_counts()["flatfat_build_query"] == 0
    assert (fq.launch_count(), fq.build_query_launch_count()) == \
        (before[0] + 1, before[1] + 1)
    fq.reset_user_launch_counts()
    assert not any(fq.user_launch_counts().values())
