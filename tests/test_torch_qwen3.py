"""Port parity: dense serving (qwen3-0.6b).  ``repro_torch``'s qwen3 config
(parameter counts, memory programs), its attention block, prefill and
decode groups, its ``Model`` and serving steps against ``repro``'s, with the
reference's initialized parameters carried across by
``model_params_from_arrays``; the port's own prefill/decode roundtrip; the
KV cache's format and its in-place decode write; and one attached prefill
step against the reference's attach on the same memory program.

Two configurations: ``SMOKE`` (one attention block covers the sequence) and
``SMOKE`` with 32-token attention blocks over a 40-token sequence, so that
the multi-block online softmax and the padded edge run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.configs import qwen3_0_6b as r_q3cfg
from repro.launch.steps import make_prefill_step as r_make_prefill
from repro.models import Model as RModel
from repro.models import attention as r_attn
from repro.models import transformer as r_tf
from repro.models.phases import build_regions_and_phases as r_build
from repro_torch import core as T
from repro_torch.configs import qwen3_0_6b as t_q3cfg
from repro_torch.interop import model_params_from_arrays
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import Model
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as t_tf
from repro_torch.models.phases import build_regions_and_phases as t_build

torch.set_num_threads(2)

BATCH, SEQ, PAD_TO = 2, 40, 48  # 40 tokens: over one 32-token block, not a multiple of it
BLOCK = 32
# f32: the same arithmetic summed in another order; an element near zero has
# no meaningful relative error, so atol scales with the output's magnitude
F32_RTOL = 1e-4
# bf16 activations: XLA on the CPU keeps fused elementwise chains (RoPE,
# rms_norm, silu·up) in f32 and rounds once, PyTorch rounds each op to bf16,
# so the two agree at bf16's level, not bitwise.  On SMOKE each package's
# bf16 logits (forward, prefill, decode) lie 0.014-0.015 (max-relative) from
# its own f32 model's and 0.008-0.010 from each other's; the bar is twice a
# package's own bf16 error.
BF16_REL = 3e-2
ROUNDTRIP_REL = 5e-4  # prefill S-1 + decode 1 against prefill S (tests/test_arch_smoke.py)


def _cfgs(dtype, blocked):
    r_cfg, t_cfg = r_q3cfg.SMOKE, t_q3cfg.SMOKE
    if blocked:
        r_cfg = dataclasses.replace(r_cfg, attn_block_q=BLOCK, attn_block_k=BLOCK)
        t_cfg = dataclasses.replace(t_cfg, attn_block_q=BLOCK, attn_block_k=BLOCK)
    if dtype == "f32":
        r_cfg = dataclasses.replace(r_cfg, dtype=jnp.float32, cache_dtype=jnp.float32)
        t_cfg = dataclasses.replace(t_cfg, dtype=torch.float32, cache_dtype=torch.float32)
    return r_cfg, t_cfg


@pytest.fixture(scope="module", params=[("f32", False), ("bf16", False), ("f32", True),
                                        ("bf16", True)],
                ids=["f32", "bf16", "f32-blocked", "bf16-blocked"])
def pair(request):
    """(dtype, reference model, its params, the port's model with them)."""
    dtype, blocked = request.param
    r_cfg, t_cfg = _cfgs(dtype, blocked)
    r_model = RModel(r_cfg)
    params = r_model.init(jax.random.PRNGKey(0))
    t_model = model_params_from_arrays(t_cfg, jax.tree.map(np.asarray, params), device="cpu")
    return dtype, r_model, params, t_model


def _tokens(seq=SEQ, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (BATCH, seq)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                                   atol=F32_RTOL * float(np.abs(want).max()))
    else:
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert rel < BF16_REL, rel


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# --------------------------------------------------------------------------- #
# config and memory program
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_param_counts_exact(which):
    assert getattr(t_q3cfg, which).param_counts() == getattr(r_q3cfg, which).param_counts()


def test_config_fields_and_groups():
    cfg, ref = t_q3cfg.CONFIG, r_q3cfg.CONFIG
    assert cfg.group_spec() == (("attn", "mlp"),) and cfg.n_groups == 28
    assert cfg.attn_layers_per_group == 1 and cfg.mamba_layers_per_group == 0
    for f in ("causal", "window", "attn_block_q", "attn_block_k", "d_head", "rope_theta",
              "qk_norm"):
        assert getattr(cfg, f) == getattr(ref, f), f


def _rows(phases):
    return [(p.name, p.flops, tuple(dataclasses.astuple(a) for a in p.accesses))
            for p in phases]


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dense_programs_equal_reference(which, kind):
    """The dense serving programs, with their ``block{g}.kv`` region and
    its accesses, equal the reference's event for event."""
    kw = dict(batch=8, seq=4096 if kind == "prefill" else 1, cache_len=4096)
    r_reg, r_ph = r_build(getattr(r_q3cfg, which), kind, **kw)
    t_reg, t_ph = t_build(getattr(t_q3cfg, which), kind, **kw)
    assert [dataclasses.astuple(r) for r in r_reg] == [dataclasses.astuple(t) for t in t_reg]
    assert _rows(r_ph) == _rows(t_ph)
    assert "block0.kv" in t_reg
    assert any(a.region == "block0.kv" and a.is_write for a in t_ph[1].accesses)
    small = dict(batch=2, seq=64 if kind == "prefill" else 1, cache_len=64)
    r_reg, r_ph = r_build(getattr(r_q3cfg, which), kind, **small)
    t_reg, t_ph = t_build(getattr(t_q3cfg, which), kind, **small)
    want = R.synthesize_skeleton(r_ph, r_reg, R.TPU_V5E, epoch_mode="layer")
    got = T.synthesize_skeleton(t_ph, t_reg, T.TPU_V5E, epoch_mode="layer")
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)


# --------------------------------------------------------------------------- #
# weights carried across
# --------------------------------------------------------------------------- #


def test_params_carried_across_exactly(pair):
    _, _, params, t_model = pair
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert sum(p.numel() for p in t_model.parameters()) == sum(v.size for v in flat.values())
    blk = t_model.blocks[1].sub0
    for name, got in (("attn']['wq", blk.attn["wq"]), ("attn']['k_norm", blk.attn["k_norm"]),
                      ("mlp']['wu", blk.mlp["wu"]), ("norm2", blk.norm2)):
        np.testing.assert_array_equal(got.detach().numpy(),
                                      flat[f"['blocks']['sub0']['{name}']"][1])


def test_interop_refuses_a_tree_that_does_not_fit():
    cfg = t_q3cfg.SMOKE
    tree = jax.tree.map(np.asarray, RModel(r_q3cfg.SMOKE).init(jax.random.PRNGKey(0)))
    sub = dict(tree["blocks"]["sub0"])
    short = dict(tree, blocks={"sub0": {k: v for k, v in sub.items() if k != "mlp"}})
    with pytest.raises(KeyError, match="no leaf 'blocks.sub0.mlp"):
        model_params_from_arrays(cfg, short, device="cpu")
    attn = {k: v for k, v in sub["attn"].items() if k != "q_norm"}
    with pytest.raises(KeyError, match="no leaf 'blocks.sub0.attn.q_norm"):
        model_params_from_arrays(cfg, dict(tree, blocks={"sub0": dict(sub, attn=attn)}),
                                 device="cpu")
    wide = dict(sub, attn=dict(sub["attn"], wk=np.zeros((2, 64, 65), np.float32)))
    with pytest.raises(ValueError, match="wk"):
        model_params_from_arrays(cfg, dict(tree, blocks={"sub0": wide}), device="cpu")


# --------------------------------------------------------------------------- #
# blocks: attention, prefill group, decode group
# --------------------------------------------------------------------------- #


def _h(dtype, seq=SEQ, seed=2):
    h = np.random.default_rng(seed).standard_normal((BATCH, seq, t_q3cfg.SMOKE.d_model))
    h = h.astype(np.float32)
    r_dt, t_dt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    return jnp.asarray(h, r_dt), torch.from_numpy(h).to(t_dt)


def _positions(seq=SEQ, offset=0):
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32) + offset, (BATCH, seq)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


def _group(params, t_model, g=0):
    return jax.tree.map(lambda a: a[g], params["blocks"]), t_model.blocks[g]


def test_attention_block_matches_reference(pair):
    dtype, r_model, params, t_model = pair
    cfg = t_model.cfg
    r_g, t_g = _group(params, t_model)
    rh, th = _h(dtype)
    r_pos, t_pos = _positions()
    dims = (cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    kw = dict(causal=True, rope_variant="rope", qk_norm=True, theta=cfg.rope_theta,
              block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    want = r_attn.attention_block(r_g["sub0"]["attn"], rh, r_pos, *dims, **kw)
    with torch.no_grad():
        got = t_attn.attention_block(t_g.sub0.attn, th, t_pos, *dims, **kw)
    assert got.dtype == th.dtype
    _close(got, want, dtype)


def test_prefill_group_matches_reference(pair):
    """The attention group with ``collect_cache``: output, and K/V padded to
    ``cache_pad_to`` in ``cache_dtype``."""
    dtype, r_model, params, t_model = pair
    r_g, t_g = _group(params, t_model)
    rh, th = _h(dtype)
    r_pos, t_pos = _positions()
    r_x, _, r_cache = r_tf.apply_group(r_g, rh, r_pos, r_model.cfg, collect_cache=True,
                                       cache_pad_to=PAD_TO)
    with torch.no_grad():
        t_x, aux, t_cache = t_tf.apply_group(t_g, th, t_pos, t_model.cfg, collect_cache=True,
                                             cache_pad_to=PAD_TO)
    assert float(aux) == 0.0 and set(t_cache) == {"kv"}
    _close(t_x, r_x, dtype)
    for kk in ("k", "v"):
        got = t_cache["kv"][kk]
        assert got.shape == (1, BATCH, 2, PAD_TO, 32) and got.dtype == t_model.cfg.cache_dtype
        assert not got[:, :, :, SEQ:].any()  # the padding is zero
        _close(got, r_cache["kv"][kk], dtype)


def test_decode_group_matches_reference(pair):
    """One token through the attention group from a prefilled cache: output,
    and the cache written at slot ``cache_len`` (in place in the port)."""
    dtype, r_model, params, t_model = pair
    r_g, t_g = _group(params, t_model)
    rh, th = _h(dtype)
    r_pos, t_pos = _positions()
    _, _, r_cache = r_tf.apply_group(r_g, rh, r_pos, r_model.cfg, collect_cache=True,
                                     cache_pad_to=PAD_TO)
    with torch.no_grad():
        _, _, t_cache = t_tf.apply_group(t_g, th, t_pos, t_model.cfg, collect_cache=True,
                                         cache_pad_to=PAD_TO)
    rh1, th1 = _h(dtype, seq=1, seed=3)
    r_pos1, t_pos1 = _positions(1, offset=SEQ)
    r_out, r_new = r_tf.decode_group(r_g, rh1, r_pos1, r_cache, SEQ, r_model.cfg)
    k_before = t_cache["kv"]["k"]
    with torch.no_grad():
        t_out, t_new = t_tf.decode_group(t_g, th1, t_pos1, t_cache, SEQ, t_model.cfg)
    assert t_new == {}  # no Mamba2 cache; the KV slices were written in place
    _close(t_out, r_out, dtype)
    assert t_cache["kv"]["k"] is k_before and k_before[:, :, :, SEQ].any()
    for kk in ("k", "v"):
        _close(t_cache["kv"][kk], r_new["kv"][kk], dtype)


# --------------------------------------------------------------------------- #
# the model and the serving steps
# --------------------------------------------------------------------------- #


def test_model_forward_matches_reference(pair):
    dtype, r_model, params, t_model = pair
    tok = _tokens()
    want, _ = r_model.forward(params, jnp.asarray(tok))
    with torch.no_grad():
        got, aux = t_model(torch.from_numpy(tok).long())
    assert got.shape == (BATCH, SEQ, 512) and float(aux) == 0.0
    _close(got, want, dtype)


def test_model_prefill_and_decode_match_reference(pair):
    """The serving steps: a prefill padded to ``PAD_TO``, then two decode
    steps, each from the last step's caches."""
    dtype, r_model, params, t_model = pair
    tok = _tokens()
    r_logits, r_caches, r_len = r_model.prefill(params, jnp.asarray(tok), pad_to=PAD_TO)
    prefill = make_prefill_step(t_model.cfg, pad_to=PAD_TO)
    t_logits, t_caches, t_len = prefill(t_model, {"tokens": torch.from_numpy(tok).long()})
    assert t_len == int(r_len) == SEQ
    _close(t_logits, r_logits, dtype)
    assert set(t_caches) == set(r_caches) == {"kv"}
    for kk in ("k", "v"):
        assert t_caches["kv"][kk].shape == r_caches["kv"][kk].shape
        _close(t_caches["kv"][kk], r_caches["kv"][kk], dtype)

    decode = make_decode_step(t_model.cfg)
    state = {"caches": t_caches, "cache_len": t_len}
    for step in range(2):
        nxt = _tokens(1, seed=5 + step)
        r_logits, r_caches = r_model.decode_step(params, r_caches, jnp.asarray(nxt), r_len)
        r_len = r_len + 1
        t_logits, new, t_len1 = decode(t_model, dict(state, token=torch.from_numpy(nxt).long()))
        assert t_len1 == state["cache_len"] + 1 and new["kv"]["k"] is t_caches["kv"]["k"]
        _close(t_logits, r_logits, dtype)
        for kk in ("k", "v"):
            _close(new["kv"][kk], r_caches["kv"][kk], dtype)
        state = {"caches": new, "cache_len": t_len1}


@pytest.mark.parametrize("blocked", [False, True], ids=["SMOKE", "blocked"])
def test_prefill_then_decode_reproduces_prefill(blocked):
    """Prefill S-1 tokens, decode the last: the last logits of a prefill of
    all S, under the reference's bar (tests/test_arch_smoke.py), in f32."""
    cfg = _cfgs("f32", blocked)[1]
    model = Model(cfg, device="cpu", seed=0)
    tok = torch.from_numpy(_tokens()).long()
    want, _, _ = make_prefill_step(cfg)(model, {"tokens": tok})
    _, caches, clen = make_prefill_step(cfg, pad_to=SEQ + 4)(model, {"tokens": tok[:, :-1]})
    got, _, _ = make_decode_step(cfg)(model, {"token": tok[:, -1:], "caches": caches,
                                               "cache_len": clen})
    assert _rel(got, want) < ROUNDTRIP_REL


def test_init_caches_match_reference_shapes():
    r_c = RModel(r_q3cfg.SMOKE).init_caches(BATCH, 64)
    t_c = Model(t_q3cfg.SMOKE, device="cpu").init_caches(BATCH, 64)
    assert set(t_c) == set(r_c) == {"kv"}
    for kk in ("k", "v"):
        got, want = t_c["kv"][kk], r_c["kv"][kk]
        assert (tuple(got.shape), str(got.dtype)) == (tuple(want.shape), "torch." + str(want.dtype))
        assert not got.any()


def test_decode_from_zero_caches_matches_reference():
    """Decode from ``init_caches`` (slot 0, nothing before it) in f32."""
    r_cfg, t_cfg = _cfgs("f32", False)
    r_model = RModel(r_cfg)
    params = r_model.init(jax.random.PRNGKey(0))
    t_model = model_params_from_arrays(t_cfg, jax.tree.map(np.asarray, params), device="cpu")
    nxt = _tokens(1, seed=9)
    want, _ = r_model.decode_step(params, r_model.init_caches(BATCH, 16), jnp.asarray(nxt), 0)
    got, _, _ = make_decode_step(t_cfg)(t_model, {"token": torch.from_numpy(nxt).long(),
                                                  "caches": t_model.init_caches(BATCH, 16),
                                                  "cache_len": 0})
    _close(got, want, "f32")


def test_decode_past_the_cache_raises_where_the_reference_clamps():
    """A decode at slot ``Smax`` (past the padded cache): the reference's
    ``dynamic_update_slice`` clamps the index and overwrites the last slot
    without a word; the port's indexed write raises."""
    cfg = t_q3cfg.SMOKE
    rng = np.random.default_rng(4)
    ck = rng.standard_normal((BATCH, 2, 8, 32)).astype(np.float32)
    new = rng.standard_normal((BATCH, 2, 1, 32)).astype(np.float32)
    clamped = jax.lax.dynamic_update_slice(jnp.asarray(ck), jnp.asarray(new), (0, 0, 8, 0))
    np.testing.assert_array_equal(np.asarray(clamped)[:, :, 7:], new)  # slot 7 overwritten
    model = Model(cfg, device="cpu")
    caches = model.init_caches(BATCH, 8)
    with pytest.raises(IndexError):
        make_decode_step(cfg)(model, {"token": torch.zeros(BATCH, 1, dtype=torch.long),
                                      "caches": caches, "cache_len": 8})


# --------------------------------------------------------------------------- #
# attached: the SMOKE prefill step under CXLMemSim
# --------------------------------------------------------------------------- #

POLICY = {"kvcache": "cxl_pool1"}  # the paper's KV-in-the-pool case
EVENTS = 256


def test_attached_prefill_matches_reference_attach():
    r_regions, r_phases = r_build(r_q3cfg.SMOKE, "prefill", batch=BATCH, seq=SEQ)
    sim = R.CXLMemSim(
        R.figure1_topology(), R.ClassMapPolicy(POLICY), epoch=R.EpochSchedule("layer"),
        hw=R.TPU_V5E, max_events_per_access=EVENTS,
    )
    r_params = RModel(r_q3cfg.SMOKE).init(jax.random.PRNGKey(0))
    tok = _tokens()
    r_step = jax.jit(r_make_prefill(r_q3cfg.SMOKE))
    with sim.attach(r_step, r_phases, r_regions) as prog:
        want = prog.run(2, r_params, {"tokens": jnp.asarray(tok)})

    t_regions, t_phases = t_build(t_q3cfg.SMOKE, "prefill", batch=BATCH, seq=SEQ)
    t_sim = T.CXLMemSim(
        T.figure1_topology(), T.ClassMapPolicy(POLICY), epoch=T.EpochSchedule("layer"),
        hw=T.TPU_V5E, max_events_per_access=EVENTS, device="cpu",
    )
    model = model_params_from_arrays(t_q3cfg.SMOKE, jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    with t_sim.attach(make_prefill_step(t_q3cfg.SMOKE), t_phases, t_regions) as t_prog:
        got = t_prog.run(2, model, {"tokens": torch.from_numpy(tok).long()})
    assert got.steps == want.steps == 2 and got.epochs == want.epochs
    assert got.epochs == 2 * (1 + t_q3cfg.SMOKE.n_layers)
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5), f
    assert got.latency_s > 0 and got.bandwidth_s > 0
    np.testing.assert_allclose(got.per_switch_congestion_ns, want.per_switch_congestion_ns,
                               rtol=1e-5, atol=1e-2)


# --------------------------------------------------------------------------- #
# the bf16 roundtrip at full width: the witness for chip_smoke.py's guard
# --------------------------------------------------------------------------- #

ROUNDTRIP_BF16_BAR = 3e-2  # chip_smoke.py's Q3_ROUNDTRIP_BF16, held on every sequence


def test_full_width_bf16_roundtrip_in_the_reference():
    """At chip_smoke.py's width and depth (qwen3-0.6b cut to 2 layers, a
    4096-token sequence, the cache padded to 4112), the reference's own bf16
    prefill of S-1 tokens plus one decode step parts from its prefill of S
    by 0.0059 on this sequence: the bar on every sequence is five times
    that.  (Without the padding the reference's decode would overwrite the
    last prefilled slot: see
    test_decode_past_the_cache_raises_where_the_reference_clamps.)"""
    cfg = dataclasses.replace(r_q3cfg.CONFIG, n_layers=2)
    r_model = RModel(cfg)
    params = jax.jit(r_model.init)(jax.random.PRNGKey(0))
    tok = jnp.asarray(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 4096)),
                      jnp.int32)
    prefill = jax.jit(lambda p, t: r_model.prefill(p, t, pad_to=4112))
    want, _, _ = prefill(params, tok)
    _, caches, clen = prefill(params, tok[:, :-1])
    got, _ = jax.jit(r_model.decode_step)(params, caches, tok[:, -1:], clen)
    split = _rel(_np(got), _np(want))
    print(f"the reference's bf16 roundtrip at 2 layers, full width: {split}")
    assert 0.0 < split and 4 * split < ROUNDTRIP_BF16_BAR
