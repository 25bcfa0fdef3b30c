"""The port's simdim (``repro_torch.analysis``'s units and axes checkers and
the runtime ``AxisSanitizer``) on the CPU: the reference's seeded corpus,
PyTorch's idioms (``permute``, ``transpose``, ``dim=`` / ``keepdim=``
reductions, ``torch.vmap``) on inline corpora, transposed dispatches into
the analyzer's surfaces and the kernel entry points raising before any
launch, the same violation message and cycle as the reference's, and the
bitwise neutrality of the port's ``core.units`` helpers.
"""

import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.analysis as R
from repro.analysis import annotations as RA
from repro_torch import analysis as P
from repro_torch import annotations as TA
from repro_torch.analysis.framework import CheckConfig
from repro_torch.analysis.sanitize import AxisSanitizer
from repro_torch.annotations import AxisContractError, axes, axes_validation, unit
from repro_torch.core import analyzer as t_an
from repro_torch.core import units as U
from repro_torch.kernels import congestion as t_kernel
from repro_torch.kernels import ops as t_ops

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "simlint"


def _check(*names, checkers=None, config=None):
    return P.run_checks([FIXTURES / n for n in names], root=FIXTURES,
                        checker_names=checkers, config=config)


def _rules(rep):
    out = {}
    for f in rep.findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out


def _ref_config():
    ref = R.CheckConfig()
    return CheckConfig(exclude=ref.exclude, axes_required=ref.axes_required,
                       summary_contracts=ref.summary_contracts)


# --------------------------------------------------------------------------- #
# units checker
# --------------------------------------------------------------------------- #


def test_units_and_axes_checkers_are_registered():
    assert {"units", "axes", "dispatch"} <= set(P.registered_checkers())


def test_units_corpus_all_rules_fire():
    rep = _check("bad_units.py", checkers=["units"])
    assert _rules(rep) == {
        "unit-mismatch": 4, "unit-return": 1, "unit-raw-conversion": 1,
    }, [f.format() for f in rep.findings]
    msgs = [f.message for f in rep.findings]
    assert "mixing ns with s" in msgs and "comparison of ns against s" in msgs
    assert any("expects a ns input, got s" in m for m in msgs)
    assert any("repro_torch.core.units" in m for m in msgs)


def test_units_clean_counterpart_and_bandwidth_identity():
    # good_units.py relies on GB/s == bytes/ns: wbytes / bw_gbps is already
    # nanoseconds and must not be flagged
    rep = _check("good_units.py", checkers=["units"])
    assert rep.ok, [f.format() for f in rep.findings]


def test_units_exempt_only_the_ports_units_module(tmp_path):
    text = "def convert(latency_ns):\n    return latency_ns * 1e-9\n"
    rel = tmp_path / "repro_torch" / "core"
    rel.mkdir(parents=True)
    (rel / "units.py").write_text(text)
    (rel / "other.py").write_text(text)
    rep = P.run_checks([rel], root=tmp_path, checker_names=["units"])
    assert [(Path(f.path).name, f.rule) for f in rep.findings] == [
        ("other.py", "unit-raw-conversion")]


# --------------------------------------------------------------------------- #
# axes checker
# --------------------------------------------------------------------------- #


def test_axes_corpus_all_rules_fire():
    """With the reference's surfaces named, the reference's counts."""
    rep = _check("bad_axes.py", checkers=["axes"], config=_ref_config())
    assert _rules(rep) == {"axes-missing": 1, "axes-mismatch": 3, "axes-rank": 2}, [
        f.format() for f in rep.findings]
    mism = [f.message for f in rep.findings if f.rule == "axes-mismatch"]
    assert any("transposed" in m for m in mism), mism
    assert _check("good_axes.py", checkers=["axes"], config=_ref_config()).ok


def test_axes_missing_names_the_ports_surface(tmp_path):
    p = tmp_path / "analyzer.py"
    p.write_text("def _analyze_batch(t, pool):\n    return t\n")
    rep = P.run_checks([p], root=tmp_path, checker_names=["axes"])
    assert [f.rule for f in rep.findings] == ["axes-missing"]
    assert "_analyze_batch" in rep.findings[0].message


def test_axes_required_surfaces_all_annotated_in_the_port():
    rep = P.run_checks([REPO / "src" / "repro_torch"], root=REPO, checker_names=["axes"])
    assert not rep.findings, [f.format() for f in rep.findings]
    assert {"_analyze_batch", "_sweep_cascades", "_sweep_reduce", "_analyze_fleet",
            "_analyze_pipeline"} <= set(CheckConfig().axes_required)


TORCH_BAD = '''
import torch

from repro_torch.annotations import axes


@axes("B,N", bits="B,N")
def cascade(t, bits):
    return t.sum(dim=1) + bits.sum(dim=1)


@axes("B,N", bits="B,N")
def permuted(t, bits):
    return cascade(t.permute(1, 0), bits)          # axes-mismatch


@axes("B,N", bits="B,N")
def swapped(t, bits):
    return cascade(torch.transpose(t, 0, 1), bits)  # axes-mismatch


@axes("B,N", bits="B,N")
def transposed_mt(t, bits):
    return cascade(t, bits.mT)                      # axes-mismatch


@axes("B,N", bits="B,N")
def reduced(t, bits):
    return cascade(t.sum(dim=1, keepdim=False), bits)  # axes-rank


@axes("B,N")
def out_of_range(t):
    return t.amax(dim=(0, 2))                      # axes-rank


@axes("K,B,N", bits="K,B,N")
def vmapped(t, bits):
    def one(x, b):
        return cascade(x.transpose(0, 1), b)       # axes-mismatch, in the closure

    return torch.vmap(one)(t, bits)
'''
TORCH_GOOD = '''
import torch

from repro_torch.annotations import axes


@axes("B,N", bits="B,N")
def cascade(t, bits):
    return t.sum(dim=1) + bits.sum(dim=1)


@axes("G,N", bits="G,N")
def renamed(t, bits):
    return cascade(t, bits)


@axes("B,N", bits="B,N")
def roundtrip(t, bits):
    back = t.transpose(0, 1).transpose(0, 1)
    return cascade(back.to(torch.float32).contiguous(), torch.where(bits > 0, bits, 0))


@axes("B,N", bits="B,N")
def kept(t, bits):
    row = t.amax(dim=1, keepdim=True)               # [B, _]
    col = t[None, ...][0]                           # [B, N]
    return cascade(col - row, bits.unsqueeze(0)[0])


@axes("K,B,N", bits="K,B,N")
def vmapped(t, bits):
    def one(x, b):
        return cascade(x, b)

    return torch.vmap(one)(t, bits) + torch.vmap(one, in_dims=(0, 0))(t, bits)


@axes("B,N")
def pairs(t):
    values = t.max(dim=1).values                   # (values, indices): untracked
    return values, t.sum((0, 1))
'''


@pytest.mark.parametrize("case", ["bad", "good"])
def test_axes_follow_pytorch_idioms(case, tmp_path):
    p = tmp_path / f"{case}_torch_axes.py"
    p.write_text(TORCH_BAD if case == "bad" else TORCH_GOOD)
    rep = P.run_checks([p], root=tmp_path, checker_names=["axes"])
    if case == "good":
        assert rep.ok, [f.format() for f in rep.findings]
        return
    assert _rules(rep) == {"axes-mismatch": 4, "axes-rank": 2}, [
        f.format() for f in rep.findings]
    lines = {f.line for f in rep.findings}
    src = TORCH_BAD.splitlines()
    assert all("axes-" in src[ln - 1] for ln in lines), lines


# --------------------------------------------------------------------------- #
# the annotation layer
# --------------------------------------------------------------------------- #


def test_unit_marker_is_identity():
    x = torch.arange(4.0)
    assert unit("ns", x) is x
    with pytest.raises(ValueError):
        unit("", x)


def test_axes_decorator_rejects_bad_specs():
    with pytest.raises(ValueError):
        axes("K,B!,N")(lambda t: t)
    with pytest.raises(ValueError):
        axes(nosuch="K,N")(lambda t: t)
    with pytest.raises(ValueError):
        axes("K", "B", "N")(lambda t: t)  # more specs than parameters


@axes("K,B,N", bw="K,B", stts="S")
def _toy_dispatch(t, bw, stts, n_hosts=1):
    # rank-agnostic body: runs (wrongly) even on a transposed plane, so the
    # sanitizer is the only thing between the bug and a result
    return t.sum(dim=-1) + bw.sum() * 0 + stts.sum() * 0


def _toy_args(transpose_t=False):
    K, B, N, S = 2, 3, 4, 5
    t = torch.ones((K, B, N))
    if transpose_t:
        t = t.permute(1, 0, 2)  # [B, K, N]: the seeded violation
    return t, torch.ones((K, B)), torch.ones((S,))


def test_sanitizer_passes_valid_shapes_and_counts_its_checks():
    with AxisSanitizer() as san:
        out = _toy_dispatch(*_toy_args())
        _toy_dispatch(*_toy_args())
    assert out.shape == (2, 3) and san.checks == 2
    _toy_dispatch(*_toy_args())  # unarmed: no check
    assert san.checks == 2


@pytest.mark.no_sanitize  # asserts the wrapper is inert outside any scope
def test_sanitizer_detects_transposed_dispatch():
    t, bw, stts = _toy_args(transpose_t=True)
    with AxisSanitizer():
        with pytest.raises(AxisContractError, match="axis"):
            _toy_dispatch(t, bw, stts)
    assert _toy_dispatch(t, bw, stts).shape == (3, 2)


def test_sanitizer_record_only_and_innermost_scope_wins():
    t, bw, stts = _toy_args(transpose_t=True)
    with AxisSanitizer(record_only=True) as san:
        out = _toy_dispatch(t, bw, stts)
    assert out.shape == (3, 2)
    assert san.violations and all("_toy_dispatch" in v for v in san.violations)
    with axes_validation():  # a raising outer scope
        with AxisSanitizer(record_only=True) as inner:
            _toy_dispatch(t, bw, stts)
        assert inner.violations
        with pytest.raises(AxisContractError):
            _toy_dispatch(t, bw, stts)


def test_violation_message_parity_with_the_reference():
    """One function, the same shapes: the same AxisContractError message
    from either package's wrapper."""
    def dispatch(t, bw, stts):
        return t

    t = np.ones((3, 2, 4))  # [B, K, N] into [K, B, N]
    bw, stts = np.ones((2, 3)), np.ones((5,))
    msgs = []
    for mod in (RA, TA):
        f = mod.axes("K,B,N", bw="K,B", stts="S")(dispatch)
        with mod.axes_validation():
            with pytest.raises(mod.AxisContractError) as err:
                f(t, bw, stts)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "transposed or mismatched dispatch" in msgs[0]


# --------------------------------------------------------------------------- #
# transposed dispatches into the port's own surfaces, on the CPU
# --------------------------------------------------------------------------- #


def _batch_args(transpose=False):
    B, N, V, S = 3, 16, 4, 2
    gen = torch.Generator().manual_seed(0)
    t = torch.sort(torch.rand(B, N, generator=gen) * 1e4).values
    if transpose:
        t = t.T.contiguous()  # [N, B]: the seeded violation
    return dict(
        t=t, pool=torch.zeros(B, N, dtype=torch.int32), nbytes=torch.full((B, N), 64.0),
        weight=torch.ones(B, N), host=None, valid=torch.ones(B, N, dtype=torch.bool),
        bw_window_ns=torch.full((B,), 1e3), lat_scale=torch.ones(B, V),
        bits_table=torch.tensor([0, 1, 3, 1], dtype=torch.int32),
        pool_latency_ns=torch.tensor([100.0, 250.0, 300.0, 250.0]),
        local_latency_ns=torch.tensor(100.0), route=torch.ones(V, S),
        switch_stt_ns=torch.tensor([2.0, 1.0]), switch_bw=torch.tensor([64.0, 32.0]),
        stage_order=(0, 1), n_windows=8,
    )


@pytest.mark.parametrize("surface", ["_analyze_batch", "congestion_cascade",
                                     "qos_congestion_cascade"])
def test_transposed_dispatch_raises_before_any_launch(surface):
    a = _batch_args(transpose=True)
    bits = torch.ones(3, 16, dtype=torch.int32)
    stts = torch.tensor([2.0, 1.0])
    calls = {
        "_analyze_batch": lambda: t_an._analyze_batch(**a),
        "congestion_cascade": lambda: t_ops.congestion_cascade(a["t"], bits, stts),
        "qos_congestion_cascade": lambda: t_ops.qos_congestion_cascade(
            a["t"], bits, stts, torch.zeros(3, 16, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), torch.ones(2, 2)),
    }
    before = (t_ops.plain_launches, t_kernel.launches, t_kernel.qos_launches)
    with AxisSanitizer():
        with pytest.raises(AxisContractError, match="transposed or mismatched"):
            calls[surface]()
    assert (t_ops.plain_launches, t_kernel.launches, t_kernel.qos_launches) == before


def test_armed_analyzer_dispatch_is_bitwise_the_unarmed_one():
    a = _batch_args()
    off = t_an._analyze_batch(**a)
    with AxisSanitizer() as san:
        armed = t_an._analyze_batch(**a)
    assert san.checks >= 2  # the surface and the cascade under it
    assert torch.equal(armed, off) and torch.isfinite(off).all()
    assert t_an._analyze_batch.__wrapped__(**a).equal(off)
    assert list(inspect.signature(t_an._analyze_batch).parameters)[:2] == ["t", "pool"]


# --------------------------------------------------------------------------- #
# the port's units helpers: bitwise the raw literal arithmetic
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("x", [0.0, 1.0, 137.25, 3.333e7, 1e-3])
def test_units_helpers_match_raw_literal_arithmetic(x):
    assert U.ns_to_s(x) == x * 1e-9
    assert U.s_to_ns(x) == x * 1e9
    assert U.s_to_ms(x) == x * 1e3
    assert U.ns_to_ms(x) == x / 1e6
    assert U.ms_to_ns(x) == x * 1e6
    assert U.ns_to_us(x) == x / 1e3
    assert U.us_to_ns(x) == x * 1e3
    assert U.bytes_to_mib(x) == x / 2**20
    assert U.mib_to_bytes(x) == x * 2**20
    assert U.bytes_to_gib(x) == x / 2**30
    assert U.gib_to_bytes(x) == x * 2**30


def test_units_constants_values():
    assert U.NS_PER_S == 1e9 and U.S_PER_NS == 1e-9
    assert U.NS_PER_MS == 1e6 and U.NS_PER_US == 1e3
    assert U.BYTES_PER_GIB == 2**30 and U.BYTES_PER_MIB == 2**20
    assert U.BYTES_PER_GB == 1e9 and U.MS_PER_S == 1e3
