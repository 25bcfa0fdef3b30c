"""Port parity: the Mamba2 serving path.  ``repro_torch``'s mamba2 config
(parameter counts, memory programs), its Mamba2 block, prefill and decode,
its ``Model`` and serving steps against ``repro``'s, with the reference's
initialized parameters carried across by ``model_params_from_arrays``; the
port's own prefill/decode roundtrip; and one attached prefill step against
the reference's attach on the same memory program."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.configs import mamba2_2_7b as r_m2cfg
from repro.launch.steps import make_prefill_step as r_make_prefill
from repro.models import Model as RModel
from repro.models import mamba2 as r_m2
from repro.models.phases import build_regions_and_phases as r_build
from repro_torch import core as T
from repro_torch.configs import mamba2_2_7b as t_m2cfg
from repro_torch.interop import model_params_from_arrays
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import Model, ModelConfig
from repro_torch.models import mamba2 as t_m2
from repro_torch.models.phases import build_regions_and_phases as t_build

torch.set_num_threads(2)

BATCH, SEQ = 2, 40  # 40 tokens: not a multiple of SMOKE's chunk (32), so _pad_seq pads
# f32: the same arithmetic summed in another order; an element near zero has
# no meaningful relative error, so atol scales with the output's magnitude
F32_RTOL = 1e-4
# bf16 activations: XLA on the CPU keeps fused elementwise chains in f32 and
# rounds once, PyTorch rounds every op to bf16, so the two agree at bf16's
# level, not bitwise.  On SMOKE's forward each package's bf16 logits lie
# 0.11-0.13 (max-relative) from the f32 model's, and 0.042 from each other.
BF16_REL = 6e-2


def _cfgs(dtype):
    if dtype == "f32":
        return (dataclasses.replace(r_m2cfg.SMOKE, dtype=jnp.float32, cache_dtype=jnp.float32),
                dataclasses.replace(t_m2cfg.SMOKE, dtype=torch.float32,
                                    cache_dtype=torch.float32))
    return r_m2cfg.SMOKE, t_m2cfg.SMOKE


@pytest.fixture(scope="module", params=["f32", "bf16"])
def pair(request):
    """(dtype, reference model, its params, the port's model with them)."""
    r_cfg, t_cfg = _cfgs(request.param)
    r_model = RModel(r_cfg)
    params = r_model.init(jax.random.PRNGKey(0))
    t_model = model_params_from_arrays(t_cfg, jax.tree.map(np.asarray, params), device="cpu")
    return request.param, r_model, params, t_model


def _tokens(seq=SEQ, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (BATCH, seq)).astype(np.int32)


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
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
    assert getattr(t_m2cfg, which).param_counts() == getattr(r_m2cfg, which).param_counts()


def test_config_fields_and_groups():
    cfg = t_m2cfg.CONFIG
    assert cfg.group_spec() == (("mamba", None),) and cfg.n_groups == 64
    assert cfg.mamba_layers_per_group == 1 and cfg.attn_layers_per_group == 0
    assert cfg.dtype == cfg.cache_dtype == torch.bfloat16
    assert dataclasses.replace(cfg, d_ff=64).group_spec() == (("mamba", "mlp"),)
    # the other families' structure is ported (tests/test_torch_model_zoo.py);
    # the moe and hybrid forward passes too (tests/test_torch_moe.py), the
    # every family builds, the vlm and audio ones too
    from repro.models import ModelConfig as RConfig

    for fam in ("moe", "hybrid", "vlm", "audio"):
        kw = {"moe": dict(n_experts=4, top_k=2),
              "hybrid": dict(attn_every=2, n_experts=4, top_k=2, ssm_state=16, ssm_heads=4,
                             ssm_d_head=16)}.get(fam, {})
        cfg = ModelConfig("m", fam, 2, 64, 4, 2, 128, 512, **kw)
        assert cfg.group_spec() == RConfig("m", fam, 2, 64, 4, 2, 128, 512, **kw).group_spec()
        model = Model(cfg, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == cfg.param_counts()["total"]


def _allocated(regions, phases):
    """The reference's phases without its accesses to regions it never
    allocated (each must carry zero bytes)."""
    out = []
    for ph in phases:
        gone = [a for a in ph.accesses if a.region not in regions]
        assert all(a.bytes_ == 0 for a in gone)
        out.append(dataclasses.replace(
            ph, accesses=tuple(a for a in ph.accesses if a.region in regions)))
    return out


def _rows(phases):
    return [(p.name, p.flops, tuple(dataclasses.astuple(a) for a in p.accesses))
            for p in phases]


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_regions_and_phases_equal(which, kind):
    """Bitwise the reference's program, less the zero-byte KV accesses the
    reference lists for a model without attention (no KV region exists)."""
    kw = dict(batch=8, seq=4096, cache_len=4096)
    r_reg, r_ph = r_build(getattr(r_m2cfg, which), kind, **kw)
    t_reg, t_ph = t_build(getattr(t_m2cfg, which), kind, **kw)
    assert [dataclasses.astuple(r) for r in r_reg] == [dataclasses.astuple(t) for t in t_reg]
    assert _rows(_allocated(r_reg, r_ph)) == _rows(t_ph)
    assert all(a.region in t_reg for p in t_ph for a in p.accesses)
    assert len(t_ph) == 1 + getattr(t_m2cfg, which).n_layers + (2 if kind == "train" else 0)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_ssm_program_traces_where_the_reference_refuses_it(kind):
    """The reference's ssm serving program names a region it never
    allocated, so its trace synthesis raises; the port's traces, and equals
    the reference's synthesis of the repaired program event for event."""
    kw = dict(batch=2, seq=64, cache_len=64)
    r_reg, r_ph = r_build(r_m2cfg.SMOKE, kind, **kw)
    t_reg, t_ph = t_build(t_m2cfg.SMOKE, kind, **kw)
    with pytest.raises(KeyError, match="block0.kv"):
        R.synthesize_skeleton(r_ph, r_reg, R.TPU_V5E, epoch_mode="layer")
    want = R.synthesize_skeleton(_allocated(r_reg, r_ph), r_reg, R.TPU_V5E, epoch_mode="layer")
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
    np.testing.assert_array_equal(
        t_model.blocks[1].sub0.mamba["in_proj"].numpy(),
        flat["['blocks']['sub0']['mamba']['in_proj']"][1],
    )
    np.testing.assert_array_equal(t_model.embed.detach().numpy(), flat["['embed']"])


def test_interop_refuses_a_tree_that_does_not_fit():
    cfg = t_m2cfg.SMOKE
    tree = jax.tree.map(np.asarray, RModel(r_m2cfg.SMOKE).init(jax.random.PRNGKey(0)))
    short = dict(tree, blocks={"sub0": {"norm1": tree["blocks"]["sub0"]["norm1"]}})
    with pytest.raises(KeyError, match="no leaf 'blocks.sub0.mamba"):
        model_params_from_arrays(cfg, short, device="cpu")
    extra = dict(tree, lm_head=np.zeros((64, 512), np.float32))
    with pytest.raises(KeyError, match="lm_head"):
        model_params_from_arrays(cfg, extra, device="cpu")
    wide = dict(tree, final_norm=np.ones(65, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        model_params_from_arrays(cfg, wide, device="cpu")


def _block_inputs(dtype, seed=2):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((BATCH, SEQ, t_m2cfg.SMOKE.d_model)).astype(np.float32)
    rdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return jnp.asarray(h, rdt), torch.from_numpy(h).to(tdt)


def _layer0(params, t_model):
    r_p = jax.tree.map(lambda a: a[0], params["blocks"]["sub0"]["mamba"])
    return r_p, t_model.blocks[0].sub0.mamba


def _dims(cfg):
    return cfg.ssm_heads, cfg.ssm_d_head, cfg.ssm_state


def test_mamba2_block_matches_reference(pair):
    dtype, _, params, t_model = pair
    r_p, t_p = _layer0(params, t_model)
    rh, th = _block_inputs(dtype)
    want = r_m2.mamba2_block(r_p, rh, *_dims(t_m2cfg.SMOKE), chunk=32)
    with torch.no_grad():
        got = t_m2.mamba2_block(t_p, th, *_dims(t_m2cfg.SMOKE), chunk=32)
    assert got.dtype == th.dtype
    _close(got, want, dtype)


def test_mamba2_prefill_and_decode_match_reference(pair):
    dtype, _, params, t_model = pair
    r_p, t_p = _layer0(params, t_model)
    rh, th = _block_inputs(dtype)
    r_out, r_cache = r_m2.mamba2_prefill(r_p, rh, *_dims(t_m2cfg.SMOKE), chunk=32)
    with torch.no_grad():
        t_out, t_cache = t_m2.mamba2_prefill(t_p, th, *_dims(t_m2cfg.SMOKE), chunk=32)
    _close(t_out, r_out, dtype)
    assert t_cache["conv"].dtype == t_cache["ssm"].dtype == torch.float32
    _close(t_cache["conv"], r_cache["conv"], dtype)
    _close(t_cache["ssm"], r_cache["ssm"], dtype)

    # one decode step from each package's own cache
    rh1, th1 = _block_inputs(dtype, seed=3)
    r_dec, r_new = r_m2.mamba2_decode(r_p, rh1[:, :1], r_cache, *_dims(t_m2cfg.SMOKE))
    with torch.no_grad():
        t_dec, t_new = t_m2.mamba2_decode(t_p, th1[:, :1], t_cache, *_dims(t_m2cfg.SMOKE))
    _close(t_dec, r_dec, dtype)
    _close(t_new["conv"], r_new["conv"], dtype)
    _close(t_new["ssm"], r_new["ssm"], dtype)


def test_mamba2_decode_from_zero_cache_matches_reference(pair):
    dtype, _, params, t_model = pair
    r_p, t_p = _layer0(params, t_model)
    rh, th = _block_inputs(dtype, seed=4)
    r_cache = r_m2.init_mamba2_cache(BATCH, *_dims(t_m2cfg.SMOKE))
    t_cache = t_m2.init_mamba2_cache(BATCH, *_dims(t_m2cfg.SMOKE), device="cpu")
    assert {k: tuple(v.shape) for k, v in t_cache.items()} == {
        k: tuple(v.shape) for k, v in r_cache.items()}
    r_dec, _ = r_m2.mamba2_decode(r_p, rh[:, :1], r_cache, *_dims(t_m2cfg.SMOKE))
    with torch.no_grad():
        t_dec, _ = t_m2.mamba2_decode(t_p, th[:, :1], t_cache, *_dims(t_m2cfg.SMOKE))
    _close(t_dec, r_dec, dtype)


def test_model_forward_matches_reference(pair):
    dtype, r_model, params, t_model = pair
    tok = _tokens()
    want, _ = r_model.forward(params, jnp.asarray(tok))
    with torch.no_grad():
        got, aux = t_model(torch.from_numpy(tok).long())
    assert got.shape == (BATCH, SEQ, 512) and float(aux) == 0.0
    _close(got, want, dtype)


def test_model_prefill_and_decode_match_reference(pair):
    dtype, r_model, params, t_model = pair
    tok = _tokens()
    r_logits, r_caches, r_len = r_model.prefill(params, jnp.asarray(tok))
    prefill = make_prefill_step(t_model.cfg)
    t_logits, t_caches, t_len = prefill(t_model, {"tokens": torch.from_numpy(tok).long()})
    assert t_len == int(r_len) == SEQ
    _close(t_logits, r_logits, dtype)
    assert set(t_caches) == set(r_caches) == {"ssm_conv", "ssm_state"}
    for k in t_caches:
        _close(t_caches[k], r_caches[k], dtype)

    nxt = _tokens(1, seed=5)
    r_dec, r_new = r_model.decode_step(params, r_caches, jnp.asarray(nxt), r_len)
    decode = make_decode_step(t_model.cfg)
    t_dec, t_new, t_len1 = decode(t_model, {"token": torch.from_numpy(nxt).long(),
                                            "caches": t_caches, "cache_len": t_len})
    assert t_len1 == SEQ + 1
    _close(t_dec, r_dec, dtype)
    for k in t_new:
        assert t_new[k].shape == t_caches[k].shape
        _close(t_new[k], r_new[k], dtype)


def test_init_caches_match_reference_shapes():
    r_c = RModel(r_m2cfg.SMOKE).init_caches(BATCH, 64)
    t_c = Model(t_m2cfg.SMOKE, device="cpu").init_caches(BATCH, 64)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in t_c.items()} == {
        k: (tuple(v.shape), "torch." + str(v.dtype)) for k, v in r_c.items()}


# --------------------------------------------------------------------------- #
# the port on its own
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype,bar", [("f32", 5e-4), ("bf16", 2e-2)])
def test_prefill_then_decode_reproduces_forward(dtype, bar):
    """Prefill S-1 tokens, decode the last: the last-position logits of a
    forward over all S (the reference's tests/test_arch_smoke.py bar at f32;
    at bf16 the kernel-free decode recurrence against the chunked scan)."""
    cfg = _cfgs(dtype)[1]
    model = Model(cfg, device="cpu", seed=0)
    tok = torch.from_numpy(_tokens()).long()
    with torch.inference_mode():
        logits, _ = model(tok)
    _, caches, clen = make_prefill_step(cfg)(model, {"tokens": tok[:, :-1]})
    dec, _, _ = make_decode_step(cfg)(model, {"token": tok[:, -1:], "caches": caches,
                                               "cache_len": clen})
    assert _rel(dec.float(), logits[:, -1].float()) < bar


def test_random_init_follows_reference_distributions():
    model = Model(t_m2cfg.SMOKE, device="cpu", seed=0)
    p = model.blocks[0].sub0.mamba
    d, di = t_m2cfg.SMOKE.d_model, t_m2cfg.SMOKE.ssm_heads * t_m2cfg.SMOKE.ssm_d_head
    assert p["in_proj"].abs().max() <= 3 * d ** -0.5
    assert p["conv_w"].abs().max() <= 0.9 + 1e-6
    np.testing.assert_allclose(-torch.exp(p["A_log"]).numpy(), -np.linspace(1.0, 8.0, 8),
                               rtol=1e-6)
    assert float(model.embed.std()) == pytest.approx(0.02, rel=0.1)
    assert p["out_proj"].abs().max() <= 3 * di ** -0.5
    again = Model(t_m2cfg.SMOKE, device="cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_unported_families_and_mixers_name_their_slice():
    """The vlm family and the GELU MLP are ported: a vlm variant of the
    SMOKE config and the ssm family with a GELU MLP build every counted
    parameter, the MLP as the reference's ``{wi, wo}``."""
    vlm = dataclasses.replace(t_m2cfg.SMOKE, family="vlm", n_heads=4, n_kv_heads=2, d_ff=64)
    gelu = dataclasses.replace(t_m2cfg.SMOKE, d_ff=64, mlp_gated=False)
    for cfg in (vlm, gelu):
        model = Model(cfg, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == cfg.param_counts()["total"]
    assert set(model.blocks[0].sub0.mlp) == {"wi", "wo"}


def test_steps_refuse_a_model_of_another_config():
    model = Model(t_m2cfg.SMOKE, device="cpu")
    other = dataclasses.replace(t_m2cfg.SMOKE, name="other")
    with pytest.raises(ValueError, match="built for other"):
        make_prefill_step(other)(model, {"tokens": torch.zeros(1, 4, dtype=torch.long)})


# --------------------------------------------------------------------------- #
# attached: the SMOKE prefill step under CXLMemSim
# --------------------------------------------------------------------------- #

POLICY = {"param": "cxl_pool1"}
EVENTS = 256


def test_attached_prefill_matches_reference_attach():
    r_regions, r_phases = r_build(r_m2cfg.SMOKE, "prefill", batch=BATCH, seq=SEQ)
    r_phases = _allocated(r_regions, r_phases)  # the reference refuses its own
    sim = R.CXLMemSim(
        R.figure1_topology(), R.ClassMapPolicy(POLICY), epoch=R.EpochSchedule("layer"),
        hw=R.TPU_V5E, max_events_per_access=EVENTS,
    )
    r_params = RModel(r_m2cfg.SMOKE).init(jax.random.PRNGKey(0))
    tok = _tokens()
    r_step = jax.jit(r_make_prefill(r_m2cfg.SMOKE))
    with sim.attach(r_step, r_phases, r_regions) as prog:
        want = prog.run(2, r_params, {"tokens": jnp.asarray(tok)})

    t_regions, t_phases = t_build(t_m2cfg.SMOKE, "prefill", batch=BATCH, seq=SEQ)
    t_sim = T.CXLMemSim(
        T.figure1_topology(), T.ClassMapPolicy(POLICY), epoch=T.EpochSchedule("layer"),
        hw=T.TPU_V5E, max_events_per_access=EVENTS, device="cpu",
    )
    model = model_params_from_arrays(t_m2cfg.SMOKE, jax.tree.map(np.asarray, r_params),
                                     device="cpu")
    with t_sim.attach(make_prefill_step(t_m2cfg.SMOKE), t_phases, t_regions) as t_prog:
        got = t_prog.run(2, model, {"tokens": torch.from_numpy(tok).long()})
    assert got.steps == want.steps == 2 and got.epochs == want.epochs
    assert got.epochs == 2 * (1 + t_m2cfg.SMOKE.n_layers)
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5), f
    assert got.latency_s > 0 and got.bandwidth_s > 0
    np.testing.assert_allclose(got.per_switch_congestion_ns, want.per_switch_congestion_ns,
                               rtol=1e-5, atol=1e-2)


# --------------------------------------------------------------------------- #
# the bf16 roundtrip at full width: the witness for chip_smoke.py's bars
# --------------------------------------------------------------------------- #

# chip_smoke.py's bf16 roundtrip at its width and depth (mamba2-2.7b cut to 2
# layers, 8 x 4096 tokens), on the port's weights drawn on the CPU from seed
# 0 and tokens from torch.Generator seed 1 (the card draws its own).  Two of
# the 8 sequences here: 0, a typical one, and 3, on which the layers amplify
# bf16 rounding.
WIDE_BATCH, WIDE_SEQ, WIDE_ROWS = 8, 4096, (0, 3)
ROUNDTRIP_BF16_MEDIAN, ROUNDTRIP_BF16_GUARD = 3e-2, 0.15  # as in chip_smoke.py


def _reference_tree(model):
    """The reference's parameter tree holding the port model's weights
    (``blocks`` stacked on a leading group axis): the inverse of
    ``model_params_from_arrays``."""
    tree, stacked = {}, {}
    for name, p in model.named_parameters():
        if name.startswith("blocks."):
            _, g, rest = name.split(".", 2)
            stacked.setdefault(f"blocks.{rest}", {})[int(g)] = p.numpy()
        else:
            stacked[name] = {None: p.numpy()}
    for key, parts in stacked.items():
        value = parts[None] if None in parts else np.stack([parts[g] for g in sorted(parts)])
        *path, leaf = key.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _seq_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.abs(got - want).max(-1) / np.abs(want).max(-1)).tolist()


def test_full_width_bf16_roundtrip_parts_in_the_reference_too():
    """At chip_smoke.py's width and depth, the reference's own bf16
    prefill of S-1 tokens plus one decode step parts from its prefill of S
    by more than the median bar on sequence 3 (so that bar cannot hold every
    sequence), while a typical sequence stays under it; and the two
    packages' bf16 prefills of S part by about as much on that sequence.
    The guard on every sequence sits above both splits."""
    t_cfg = dataclasses.replace(t_m2cfg.CONFIG, n_layers=2)
    r_model = RModel(dataclasses.replace(r_m2cfg.CONFIG, n_layers=2))
    model = Model(t_cfg, device="cpu", seed=0)
    tree = _reference_tree(model)
    tok = torch.randint(0, t_cfg.vocab_size, (WIDE_BATCH, WIDE_SEQ),
                        generator=torch.Generator().manual_seed(1))[list(WIDE_ROWS)]
    r_tok = jnp.asarray(tok.numpy().astype(np.int32))
    prefill = jax.jit(r_model.prefill)
    want, _, _ = prefill(tree, r_tok)
    _, caches, clen = prefill(tree, r_tok[:, :-1])
    got, _ = jax.jit(r_model.decode_step)(tree, caches, r_tok[:, -1:], clen)
    want = np.asarray(want.astype(jnp.float32))
    roundtrip = _seq_rel(got.astype(jnp.float32), want)
    with torch.inference_mode():
        t_want, _, _ = make_prefill_step(t_cfg)(model, {"tokens": tok})
    packages = _seq_rel(t_want.float().numpy(), want)
    print(f"sequences {WIDE_ROWS}: the reference's bf16 roundtrip {roundtrip}, "
          f"the port's bf16 prefill against the reference's {packages}")
    typical, amplified = roundtrip
    assert typical < ROUNDTRIP_BF16_MEDIAN < amplified
    assert max(roundtrip + packages) < ROUNDTRIP_BF16_GUARD
