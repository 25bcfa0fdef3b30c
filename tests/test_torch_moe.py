"""Port parity: the MoE layer and the moe and hybrid families.
``repro_torch.models.moe`` against ``repro.models.moe`` on the same
parameters and inputs, and granite-moe-3b-a800m, llama4-maverick-400b-a17b
and jamba-v0.1-52b at ``SMOKE`` against ``repro``'s models, on the CPU.

Routes are compared first: a route that flips (a near-tie in the router's
probabilities that the two packages round apart) moves one token's output
by O(1), so each output bar below holds only where the routes are equal,
and every case checks that they are.  Bars:
- the routing (:func:`route`) on identical probabilities: indices, slots,
  the kept mask and the gates bitwise;
- ``moe_block`` at f32: output and aux at rtol 2e-5 / atol 2e-5
  (``tests/test_moe.py``'s own bar); at bf16: output within 2e-2 of its
  largest magnitude (the two packages' bf16 products round in different
  places), aux at rel 1e-5 (f32 from the same routes);
- gradients (``jax.grad`` of ``tests/test_moe.py:75``'s loss against
  autograd): rtol 1e-4, atol 1e-4 of the largest gradient element;
- the models at f32: logits and aux at rtol 1e-4 (atol 1e-4 of the largest
  logit), the lossless prefill S-1 plus one decode against the forward of S
  under 5e-4 (``tests/test_arch_smoke.py``'s bar), ``Model.loss`` at rel
  1e-5 and its gradients as above; 3 train steps as
  ``tests/test_torch_train.py`` holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data.pipeline import SyntheticPipeline as RPipeline
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import Model as RModel
from repro.models import moe as r_moe
from repro.optim import adamw as r_adamw
from repro.optim import compression as r_comp
import repro_torch.configs as TC
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.interop import (
    adamw_state_from_arrays,
    adamw_state_to_arrays,
    model_params_from_arrays,
    params_to_arrays,
)
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.models import Model
from repro_torch.models import moe as t_moe
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp

torch.set_num_threads(2)

E, D, F = 8, 32, 64  # tests/test_moe.py's layer
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_OF_MAX = 2e-2
GRAD_RTOL = GRAD_ATOL_OF_MAX = 1e-4
MODEL_RTOL = 1e-4
ROUNDTRIP_BAR = 5e-4
LOSS_REL = 1e-5
QUANT_NORM_REL = 1e-4  # tests/test_torch_train.py: an int8 level may flip
MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b")
# jamba under LONG's sliding-window attention, at a window that bites in
# the tests' 32 tokens (LONG's own 4096 would not)
SMOKE_WINDOW = 16
MODELS = MOE_ARCHS + ("jamba-v0.1-52b", "jamba-long")


# --------------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------------- #


# the reference's layer, compiled once per configuration
_ref_block = jax.jit(r_moe.moe_block,
                     static_argnames=("top_k", "capacity_factor", "dispatch", "group_tokens"))


def _layer(seed=0, shared=False):
    """The reference's ``init_moe`` parameters and the same as torch."""
    p = r_moe.init_moe(jax.random.PRNGKey(seed), D, F, E, shared_expert=shared)
    return p, {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p.items()}


def _x(seed, B=2, S=64, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(dtype)


def _ref_route(probs, top_k, cap):
    """``repro/models/moe.py``'s routing lines (``:81-82`` and ``:119-124``)
    on given probabilities."""
    Gm, gs, n_exp = probs.shape
    gate_vals, idx = jax.lax.top_k(probs, top_k)
    gates = gate_vals / jnp.clip(gate_vals.sum(-1, keepdims=True), 1e-9)
    flat = jax.nn.one_hot(idx, n_exp, dtype=jnp.int32).reshape(Gm, gs * top_k, n_exp)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = (pos * flat).sum(-1).reshape(Gm, gs, top_k)
    return idx, gates, pos, pos < cap


def _grouped(x, group):
    """``x [B, S, D]`` as the reference groups it: ``[g, gs, D]``, the last
    group padded with zeros."""
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    gs = min(group, T)
    Gm = -(-T // gs)
    xt = np.pad(xt, ((0, Gm * gs - T), (0, 0)))
    return xt.reshape(Gm, gs, -1)


def _ref_probs(router, xg):
    logits = (jnp.asarray(xg) @ router.astype(xg.dtype)).astype(jnp.float32)
    return jax.nn.softmax(logits, axis=-1)


def _assert_routes_equal(probs_np, top_k, cap):
    """The port's routing against the reference's on the same
    probabilities, bitwise; returns the port's."""
    want = _ref_route(jnp.asarray(probs_np), top_k, cap)
    got = t_moe.route(torch.from_numpy(probs_np), top_k, cap)
    for name, w, g in zip(("idx", "gates", "pos", "keep"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    return got


def _assert_same_routes(p_ref, p_port, x, top_k, group):
    """Both packages' own router probabilities route every token alike (no
    near-tie flipped), through the port's routing."""
    xg = _grouped(x, group)
    a = t_moe.route(torch.from_numpy(np.asarray(_ref_probs(p_ref["router"], xg))), top_k, 1)
    b = t_moe.route(t_moe.router_probs(p_port["router"], torch.from_numpy(xg)), top_k, 1)
    assert torch.equal(a.idx, b.idx), "a route flipped between the packages"


@pytest.mark.parametrize("cap", [1, 6, 40])
@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_routing_is_bitwise_the_reference(top_k, cap):
    """Top-k, the renormalised gates, the slots (token-major over the
    flattened [gs·k] axis) and the kept mask on the reference's own
    probabilities: 3 groups of 50 tokens, the last 20 of them padding."""
    p, _ = _layer()
    xg = _grouped(_x(1, B=2, S=65), 50)
    xg[-1, 30:] = 0.0  # the padding tokens route too
    probs = np.asarray(_ref_probs(p["router"], xg))
    got = _assert_routes_equal(probs, top_k, cap)
    assert int(got.keep.sum()) < got.keep.numel() or cap == 40


def test_ties_go_to_the_lower_expert_as_in_top_k():
    """Probabilities with exact ties at the k-th place (rounded to 1/8 and
    renormalised): the same experts, gates and slots as ``lax.top_k``;
    ``torch.topk`` promises no order among ties."""
    rng = np.random.default_rng(7)
    raw = np.round(rng.random((2, 64, E)) * 8) / 8 + 1e-3
    probs = (raw / raw.sum(-1, keepdims=True)).astype(np.float32)
    sorted_p = -np.sort(-probs, axis=-1)
    assert (sorted_p[..., 1] == sorted_p[..., 2]).sum() > 20  # ties at the k-th place
    for top_k in (1, 2, 3):
        _assert_routes_equal(probs, top_k, 16)


@pytest.mark.parametrize("dispatch", t_moe.DISPATCHES)
def test_a_zero_router_ties_every_expert(dispatch):
    """A zero router makes every probability 1/E exactly: every token goes
    to experts 0..k-1, in both packages, and the outputs agree."""
    p, tp = _layer(3)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(4)
    want, want_aux = _ref_block(p, jnp.asarray(x), top_k=2, capacity_factor=2.0,
                                     dispatch=dispatch, group_tokens=64)
    got, aux = t_moe.moe_block(tp, torch.from_numpy(x), top_k=2, capacity_factor=2.0,
                               dispatch=dispatch, group_tokens=64)
    probs = t_moe.router_probs(tp["router"], torch.from_numpy(_grouped(x, 64)))
    r = t_moe.route(probs, 2, 16)
    assert bool((r.idx == torch.tensor([0, 1])).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


@pytest.mark.parametrize("group,S", [(64, 100), (256, 128)], ids=["g64-padded", "g256"])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["lossless", "lossy"])
@pytest.mark.parametrize("dispatch", t_moe.DISPATCHES)
def test_moe_block_equals_reference_f32(dispatch, cf, shared, group, S):
    """Output and aux of the three dispatches at a lossless capacity (cf =
    E/k) and a lossy one, with and without the shared expert, on one padded
    group of 64 tokens per 100 or whole groups of 256."""
    p, tp = _layer(0, shared=shared)
    x = _x(1, S=S)
    _assert_same_routes(p, tp, x, 2, group)
    want, want_aux = _ref_block(p, jnp.asarray(x), top_k=2, capacity_factor=cf,
                                     dispatch=dispatch, group_tokens=group)
    got, aux = t_moe.moe_block(tp, torch.from_numpy(x), top_k=2, capacity_factor=cf,
                               dispatch=dispatch, group_tokens=group)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32_TOL)


def test_dispatches_agree_lossless_and_drop_when_lossy():
    """tests/test_moe.py's equivalence in the port: the three dispatches
    compute one function at a lossless capacity; a lossy one drops routes
    (the einsum and scatter dispatches agree with each other, the dense one
    drops nothing)."""
    _, tp = _layer(0)
    x = torch.from_numpy(_x(2))
    lossless = [t_moe.moe_block(tp, x, 2, float(E) / 2, d, 64)[0] for d in t_moe.DISPATCHES]
    for out in lossless[1:]:
        torch.testing.assert_close(out, lossless[0], **F32_TOL)
    lossy = {d: t_moe.moe_block(tp, x, 2, 0.25, d, 64)[0] for d in t_moe.DISPATCHES}
    torch.testing.assert_close(lossy["scatter"], lossy["einsum"], **F32_TOL)
    torch.testing.assert_close(lossy["dense"], lossless[0], **F32_TOL)
    assert float(lossy["einsum"].norm()) < float(lossless[0].norm())


@pytest.mark.parametrize("dispatch", t_moe.DISPATCHES)
def test_moe_block_bf16_within_its_bar(dispatch):
    """bf16 activations over f32 weights (cast at use), lossless: the
    routes equal, the outputs within 2e-2 of their largest magnitude."""
    p, tp = _layer(5)
    x = _x(6, dtype=np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xg = _grouped(xb.float().numpy(), 64)
    a = t_moe.route(torch.from_numpy(np.asarray(
        _ref_probs(p["router"], jnp.asarray(xg).astype(jnp.bfloat16)))), 2, 1)
    b = t_moe.route(t_moe.router_probs(tp["router"], torch.from_numpy(xg).to(torch.bfloat16)),
                    2, 1)
    assert torch.equal(a.idx, b.idx), "a bf16 route flipped between the packages"
    want, want_aux = _ref_block(p, xj, top_k=2, capacity_factor=4.0, dispatch=dispatch,
                                     group_tokens=64)
    got, aux = t_moe.moe_block(tp, xb, top_k=2, capacity_factor=4.0, dispatch=dispatch,
                               group_tokens=64)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_OF_MAX * float(np.abs(want).max()))
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


@pytest.mark.parametrize("dispatch", t_moe.DISPATCHES)
def test_gradients_equal_reference(dispatch):
    """``jax.grad`` of tests/test_moe.py:75's loss against autograd, for
    every parameter and the input, at a capacity that drops routes."""
    p, tp = _layer(0, shared=True)
    x = _x(5)
    _assert_same_routes(p, tp, x, 2, 64)

    def r_loss(params, xx):
        out, aux = r_moe.moe_block(params, xx, top_k=2, capacity_factor=2.0,
                                   dispatch=dispatch, group_tokens=64)
        return (out ** 2).mean() + 0.01 * aux

    want_p, want_x = jax.jit(jax.grad(r_loss, argnums=(0, 1)))(p, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = t_moe.moe_block(tp, xt, top_k=2, capacity_factor=2.0, dispatch=dispatch,
                               group_tokens=64)
    ((out ** 2).mean() + 0.01 * aux).backward()
    want = {**{k: np.asarray(v) for k, v in want_p.items()}, "x": np.asarray(want_x)}
    got = {**{k: v.grad.numpy() for k, v in tp.items()}, "x": xt.grad.numpy()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    assert float(np.abs(want["router"]).sum()) > 0 and float(np.abs(want["wi"]).sum()) > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * scale, err_msg=k)


def test_init_moe_names_shapes_and_scales():
    """The reference's leaves and shapes; each stacked expert matrix drawn
    from a truncated normal at the reference's fan-in scale."""
    want = r_moe.init_moe(jax.random.PRNGKey(0), D, F, E, shared_expert=True)
    got = t_moe.init_moe(torch.Generator().manual_seed(0), D, F, E, shared_expert=True)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    for k, scale in (("wi", D ** -0.5), ("wu", D ** -0.5), ("wo", F ** -0.5)):
        assert float(got[k].abs().max()) <= 3 * scale + 1e-6
        assert float(got[k].std()) == pytest.approx(float(np.std(np.asarray(want[k]))), rel=0.05)


def test_unknown_dispatch_is_refused():
    _, tp = _layer()
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        t_moe.moe_block(tp, torch.zeros(1, 4, D), 2, dispatch="sorted")


@pytest.mark.parametrize("gs,k,cf", [(4096, 8, 1.25), (8, 8, 2.0), (4096, 2, 1.25),
                                     (8, 2, 2.0), (7, 3, 0.3)])
def test_capacity_is_the_reference_float_arithmetic(gs, k, cf):
    n_exp = 40
    assert t_moe.capacity(gs, k, cf, n_exp) == max(int(gs * k * cf / n_exp), 1)


# --------------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------------- #


def _cfgs(name, **kw):
    """(reference config, port config) at f32 for a MODELS entry."""
    arch = "jamba-v0.1-52b" if name == "jamba-long" else name
    r_cfg, t_cfg = RC.get_smoke(arch), TC.get_smoke(arch)
    if name == "jamba-long":
        kw = dict(kw, window=SMOKE_WINDOW)
    return (dataclasses.replace(r_cfg, dtype=jnp.float32, cache_dtype=jnp.float32, **kw),
            dataclasses.replace(t_cfg, dtype=torch.float32, cache_dtype=torch.float32, **kw))


def _pair(r_cfg, t_cfg):
    """(reference model, weights, the port's model holding them): weights
    drawn by the port from seed 0 (the tests compare functions, not
    initializers) and carried into a second port model, both ways through
    ``repro_torch.interop``."""
    tree = params_to_arrays(Model(t_cfg, device="cpu", seed=0))
    t_model = model_params_from_arrays(t_cfg, tree, device="cpu")
    return RModel(r_cfg), jax.tree.map(jnp.asarray, tree), t_model


def _tokens(vocab, B=2, S=32, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_close_of_max(got, want, rtol=MODEL_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b"])
def test_model_builds_every_counted_parameter(arch, which):
    """The published configs on the meta device (nothing allocated) and the
    SMOKEs: the model's parameters number ``param_counts()['total']``, with
    the reference's leaves and shapes."""
    t_cfg = getattr(TC, "get_config" if which == "CONFIG" else "get_smoke")(arch)
    r_cfg = getattr(RC, "get_config" if which == "CONFIG" else "get_smoke")(arch)
    model = Model(t_cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == t_cfg.param_counts()["total"]
    shapes = {}
    for name, p in model.named_parameters():
        key = name if not name.startswith("blocks.") else "blocks." + name.split(".", 2)[2]
        shapes.setdefault(key, []).append(tuple(p.shape))
    got = {k: ((len(v),) + v[0]) if k.startswith("blocks.") else v[0] for k, v in shapes.items()}
    want = {jax.tree_util.keystr(k).replace("']['", ".").strip("[']"): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(r_cfg.param_shapes())[0]}
    assert got == want


@pytest.mark.parametrize("name", MODELS)
def test_forward_logits_and_aux_equal_reference(name):
    r_cfg, t_cfg = _cfgs(name)
    r_model, params, model = _pair(r_cfg, t_cfg)
    toks = _tokens(r_cfg.vocab_size)[:, :-1]
    want, want_aux = jax.jit(r_model.forward)(params, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(toks).long())
    _assert_close_of_max(got.numpy(), want)
    assert float(aux) > 0.5 and float(aux) == pytest.approx(float(want_aux), rel=MODEL_RTOL)


@pytest.mark.parametrize("name", MODELS)
def test_lossless_prefill_then_decode_equals_forward(name):
    """tests/test_arch_smoke.py:64-90 in the port (capacity_factor =
    decode_capacity_factor = n_experts, so no route drops): the decode's
    logits against the forward's last under 5e-4, and against the
    reference's decode at rtol 1e-4."""
    n_exp = float(_cfgs(name)[1].n_experts)
    r_cfg, t_cfg = _cfgs(name, capacity_factor=n_exp, decode_capacity_factor=n_exp)
    r_model, params, model = _pair(r_cfg, t_cfg)
    toks = torch.from_numpy(_tokens(r_cfg.vocab_size)[:, :-1]).long()
    S = toks.shape[1]
    with torch.no_grad():
        full, _ = model(toks)
    _, caches, clen = make_prefill_step(t_cfg, pad_to=S + 4)(model, {"tokens": toks[:, :-1]})
    got, new_caches, new_len = make_decode_step(t_cfg)(
        model, {"token": toks[:, -1:], "caches": caches, "cache_len": clen})
    want = full[:, -1]
    rel = float((got - want).abs().max()) / float(want.abs().max())
    assert rel < ROUNDTRIP_BAR and new_len == S
    assert set(new_caches) == set(caches)
    _, r_caches, r_len = jax.jit(r_model.prefill, static_argnames="pad_to")(
        params, jnp.asarray(toks[:, :-1].numpy()), pad_to=S + 4)
    r_got, _ = jax.jit(r_model.decode_step)(params, r_caches, jnp.asarray(toks[:, -1:].numpy()),
                                            r_len)
    _assert_close_of_max(got.numpy(), r_got)


def test_hybrid_caches_hold_one_kv_and_the_mamba_layers_per_group():
    """jamba's groups: one attention sublayer and the rest Mamba2, in the
    reference's decode format (SMOKE: groups of 4, 1 + 3; the published
    config: 1 + 7 a group of 8)."""
    cfg = TC.get_config("jamba-v0.1-52b")
    assert (cfg.attn_layers_per_group, cfg.mamba_layers_per_group, cfg.n_groups) == (1, 7, 4)
    smoke = TC.get_smoke("jamba-v0.1-52b")
    model = Model(smoke, device="cpu")
    caches = model.init_caches(2, 40)
    G, di = smoke.n_groups, smoke.ssm_heads * smoke.ssm_d_head
    assert caches["kv"]["k"].shape == (G, 1, 2, smoke.n_kv_heads, 40, smoke.d_head)
    assert caches["ssm_conv"].shape == (G, 3, 2, 3, di)
    assert caches["ssm_state"].shape == (G, 3, 2, smoke.ssm_heads, smoke.ssm_state,
                                         smoke.ssm_d_head)
    r_caches = RModel(RC.get_smoke("jamba-v0.1-52b")).init_caches(2, 40)
    assert jax.tree.map(lambda a: a.shape, r_caches) == {
        "kv": {k: tuple(v.shape) for k, v in caches["kv"].items()},
        "ssm_conv": tuple(caches["ssm_conv"].shape),
        "ssm_state": tuple(caches["ssm_state"].shape)}


def _ref_loss_and_grads(r_cfg, params, batch):
    model = RModel(r_cfg)
    return jax.jit(jax.value_and_grad(lambda p: model.loss(p, batch), has_aux=True))(params)


@pytest.mark.parametrize("name", MOE_ARCHS + ("jamba-v0.1-52b",))
def test_loss_and_gradients_equal_reference(name):
    """``Model.loss`` (cross-entropy plus 0.01·aux, a non-zero aux) and its
    gradients; jamba's through the plain chunked SSD's autograd.

    jamba's gradient of the embedding (its first sublayer is Mamba2) is
    ill-conditioned in f32: the two packages part there by 2.2e-4 of the
    gradient's largest element, where every other leaf agrees to 5e-6.  An
    x64 run of the reference (f64 compute; its norms and log-softmax stay
    f32, as written) is missed by 0.85e-4 of it by the reference's own f32
    gradient and by 1.3e-4 by the port's (ROADMAP.md queue 3).  So with
    Mamba2 layers each leaf is held to the x64 run instead: the port no
    further from it than twice the reference, or 1e-4 of the largest
    element."""
    r_cfg, t_cfg = _cfgs(name)
    _, params, model = _pair(r_cfg, t_cfg)
    toks = _tokens(r_cfg.vocab_size)
    labels = toks[:, 1:].copy()
    labels[0, -3:] = -1
    batch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    (want, want_parts), want_g = _ref_loss_and_grads(r_cfg, params, batch)
    model.requires_grad_(True)
    loss, parts = model.loss({"tokens": torch.from_numpy(toks[:, :-1]).long(),
                              "labels": torch.from_numpy(labels)})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_REL)
    assert float(parts["aux"].detach()) > 0.5
    assert float(parts["aux"].detach()) == pytest.approx(float(want_parts["aux"]), rel=LOSS_REL)
    got = _flat(params_to_arrays({k: p.grad for k, p in model.named_parameters()}))
    want_g = _flat(want_g)
    assert got.keys() == want_g.keys()
    scale = max(float(np.abs(w).max()) for w in want_g.values())
    if not t_cfg.mamba_layers_per_group:
        for k in want_g:
            np.testing.assert_allclose(got[k], want_g[k], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_OF_MAX * scale, err_msg=k)
        return
    with jax.enable_x64(True):
        r64 = dataclasses.replace(r_cfg, dtype=jnp.float64, cache_dtype=jnp.float64)
        _, exact = _ref_loss_and_grads(
            r64, jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params), batch)
        exact = _flat(exact)
    parted = 0
    for k, e in exact.items():
        assert e.dtype == np.float64
        ref_err = float(np.abs(want_g[k] - e).max())
        port_err = float(np.abs(got[k] - e).max())
        assert port_err <= max(2 * ref_err, GRAD_ATOL_OF_MAX * scale), k
        parted += float(np.abs(got[k] - want_g[k]).max()) > GRAD_ATOL_OF_MAX * scale
    assert parted <= 1  # the embedding's, as described above


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "ef-int8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_steps_equal_reference(arch, compress):
    """3 steps of ``make_train_step`` from carried weights on
    ``SyntheticPipeline`` batches: losses, aux, the schedule, the gradient
    norm and the parameters after the steps, as tests/test_torch_train.py
    holds TINY's; the int8 compression quantizes each stacked MoE leaf with
    one scale, as the reference's."""
    r_cfg, t_cfg = _cfgs(arch)
    kw = dict(lr=3e-3, total_steps=10, warmup_steps=1)
    r_opt, t_opt = r_adamw.AdamWConfig(**kw), t_adamw.AdamWConfig(**kw)
    _, params, model = _pair(r_cfg, t_cfg)
    r_state = {"adam": r_adamw.adamw_init(params, r_opt),
               "ef": r_comp.init_error_state(params) if compress else {}}
    t_state = {"adam": t_adamw.adamw_init(model, t_opt),
               "ef": t_comp.init_error_state(model) if compress else {}}
    r_step = jax.jit(r_make_train_step(r_cfg, r_opt, compress_grads=compress))
    t_step = make_train_step(t_cfg, t_opt, compress_grads=compress, device="cpu")
    r_pipe = RPipeline(r_cfg, 4, 32, seed=3)
    t_pipe = SyntheticPipeline(t_cfg, 4, 32, seed=3, device="cpu")
    lrs = []
    for step in range(3):
        params, r_state, want = r_step(params, r_state, r_pipe.device_batch(step))
        model, t_state, got = t_step(model, t_state, t_pipe.device_batch(step))
        for key in ("loss", "ce", "aux", "grad_norm"):
            rel = QUANT_NORM_REL if compress and key == "grad_norm" else LOSS_REL
            assert abs(float(got[key]) - float(want[key])) <= rel * abs(float(want[key])), key
        lrs.append(float(want["lr"]))
    atol = 2 * sum(lrs) + 1e-6
    got, want = _flat(params_to_arrays(model)), _flat(params)
    assert any("moe" in k for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
    assert int(adamw_state_to_arrays(t_state["adam"])["step"]) == 3


def test_interop_carries_moe_leaves_and_their_optimizer_state_both_ways():
    """``blocks.sub{i}.moe.*`` stacked on the leading group axis, both
    ways, with the AdamW moments; and the int8 error-feedback compression
    of those leaves bitwise the reference's (one scale per stacked leaf)."""
    r_cfg, t_cfg = _cfgs("llama4-maverick-400b-a17b")
    _, params, model = _pair(r_cfg, t_cfg)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_arrays(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert set(tree["blocks"]["sub1"]["moe"]) == {
        "router", "wi", "wu", "wo", "shared_wi", "shared_wu", "shared_wo"}
    assert tree["blocks"]["sub1"]["moe"]["wi"].shape == (1, 8, 64, 128)
    r_state = jax.tree.map(np.asarray, r_adamw.adamw_init(params, r_adamw.AdamWConfig()))
    r_state["nu"] = jax.tree.map(lambda a: a + 0.5, r_state["nu"])
    state = adamw_state_from_arrays(r_state, model, device="cpu")
    for a, b in zip(jax.tree.leaves(adamw_state_to_arrays(state)), jax.tree.leaves(r_state)):
        np.testing.assert_array_equal(a, b)
    # the MoE leaves' compression, eagerly in the reference (jit lets XLA
    # rewrite the division by the scale)
    named = {k: p.detach() * 0.1 for k, p in model.named_parameters() if ".moe." in k}
    got, err = t_comp.ef_compress(named, t_comp.init_error_state(named))
    rt = {"blocks": {"sub1": {"moe": jax.tree.map(lambda a: jnp.asarray(a * np.float32(0.1)),
                                                  tree["blocks"]["sub1"]["moe"])}}}
    want, r_err = r_comp.ef_compress(rt, r_comp.init_error_state(rt))
    for a, b in ((got, want), (err, r_err)):
        g, w = _flat(params_to_arrays(a)), _flat(b)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_hybrid_training_is_refused_on_the_card_before_any_work():
    """jamba has Mamba2 layers: its train step on the card needs the SSD
    backward kernel, which the reference does not have either; on the CPU
    it trains through the plain chunked scan."""
    opt = t_adamw.AdamWConfig()
    with pytest.raises(NotImplementedError, match="SSD backward kernel"):
        make_train_step(TC.get_smoke("jamba-v0.1-52b"), opt, device="cuda")
    make_train_step(TC.get_smoke("jamba-v0.1-52b"), opt, device="cpu")


# --------------------------------------------------------------------------- #
# model FLOPs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_model_flops_equal_reference(arch, kind):
    want = RC.get_config(arch).model_flops(kind, 8, 4096)
    assert TC.get_config(arch).model_flops(kind, 8, 4096) == want


def test_model_flops_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="serve"):
        TC.get_config("qwen3-0.6b").model_flops("serve", 1, 1)
