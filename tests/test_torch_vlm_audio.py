"""Port parity: the VLM and audio families and the two remaining dense
configurations.  ``repro_torch``'s rope2d and M-RoPE, ``layer_norm``, the
GELU MLP, embedding inputs and bidirectional attention against ``repro``'s,
through chatglm3-6b (rope2d), starcoder2-3b (GELU MLP, tied head),
qwen2-vl-72b (M-RoPE, embedding inputs) and hubert-xlarge (LayerNorm,
GELU, bidirectional, embedding inputs) at ``SMOKE``; then
``remat_policy_name="dots"``, ``configs.input_specs`` and the roofline
terms.  On the CPU, weights carried across with ``repro_torch.interop``.

Tolerances:
- ``apply_rope``, ``layer_norm`` and ``dense_mlp`` at f32: rtol 1e-6 (atol
  1e-6 of the largest magnitude; the same f32 arithmetic in another order);
- the models at f32: logits at rtol 1e-4 (atol 1e-4 of the largest logit);
  the prefill of S-1 plus one decode against the forward of S under 5e-4
  (``tests/test_arch_smoke.py``'s bar) for the three decoders, and every
  decode (hubert's too) against the reference's decode at rtol 1e-4;
- ``Model.loss`` at rel 1e-5, its gradients at rtol 1e-4 plus atol 1e-4 of
  the largest gradient element (``jax.grad`` of the reference's loss);
- 3 train steps: losses and the gradient norm at rel 1e-5 (1e-4 for the
  norm under int8 compression), the parameters after them within ``2 *
  sum(lr)`` plus 1e-6, as ``tests/test_torch_train.py`` holds them;
- the interop roundtrip and the compression of the new leaves: bitwise;
- ``input_specs`` and ``roofline_terms``: exactly equal.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.core import roofline as r_roof
from repro.core import tracer as r_tracer
from repro.data.pipeline import SyntheticPipeline as RPipeline
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import Model as RModel
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.optim import adamw as r_adamw
from repro.optim import compression as r_comp
import repro_torch.configs as TC
from repro_torch import core as T
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.interop import (
    adamw_state_from_arrays,
    adamw_state_to_arrays,
    model_params_from_arrays,
    params_to_arrays,
)
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.models import Model
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp

torch.set_num_threads(2)

OP_RTOL = 1e-6
MODEL_RTOL = 1e-4
ROUNDTRIP_BAR = 5e-4
LOSS_REL = 1e-5
GRAD_RTOL = GRAD_ATOL_OF_MAX = 1e-4
QUANT_NORM_REL = 1e-4
ARCHS = ("chatglm3-6b", "starcoder2-3b", "qwen2-vl-72b", "hubert-xlarge")
DECODERS = ARCHS[:3]


def _close_of_max(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


# --------------------------------------------------------------------------- #
# the pieces
# --------------------------------------------------------------------------- #


def _streams(n, B, S, offset, rng):
    """``[B, n, S]`` positions: the model's stub (stream 0 counts from
    ``offset``; rope2d's stream 1 zeros) or, for n=3, random streams."""
    pos = np.arange(S, dtype=np.int32)[None] + offset
    pos = np.broadcast_to(pos, (B, S))
    if n == 2:
        return np.stack([pos, np.zeros_like(pos)], axis=1)
    return np.stack([pos, rng.integers(0, 64, (B, S)), rng.integers(0, 64, (B, S))],
                    axis=1).astype(np.int32)


@pytest.mark.parametrize("D", [16, 128, 80])
@pytest.mark.parametrize("offset", [0, 37])
@pytest.mark.parametrize("variant, n_streams", [("rope2d", 2), ("mrope", 3)])
def test_apply_rope_variants_equal_reference(variant, n_streams, offset, D):
    rng = np.random.default_rng(D + offset)
    x = rng.standard_normal((2, 3, 9, D)).astype(np.float32) * 2.0
    pos = _streams(n_streams, 2, 9, offset, rng)
    for theta in (10_000.0, 1e6):
        want = r_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos), variant, theta)
        got = t_attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), variant, theta)
        assert got.dtype == torch.float32 and got.shape == x.shape
        _close_of_max(got.numpy(), want, OP_RTOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_equals_reference(dtype):
    """f32 at rtol 1e-6 (a population variance: torch's default unbiased
    one would miss by 1/d); bf16 in and out within a bf16 ulp."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 7, 48)) * 3.0 + 1.5).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    r_dt, t_dt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    want = r_layers.layer_norm(jnp.asarray(x, r_dt), jnp.asarray(g), jnp.asarray(b))
    got = t_layers.layer_norm(torch.from_numpy(x).to(t_dt), torch.from_numpy(g),
                              torch.from_numpy(b))
    assert got.dtype == t_dt
    tol = OP_RTOL if dtype == "f32" else 2 ** -7
    _close_of_max(got.float().numpy(), np.asarray(want, np.float32), tol)


def test_dense_mlp_equals_reference():
    """The reference's initial distributions (``init_dense_mlp``: ``wi``
    and ``wo`` fan-in truncated normals) and the tanh GELU (the exact erf
    form would miss by up to about 1e-3 of an activation)."""
    rng = np.random.default_rng(4)
    p = r_layers.init_dense_mlp(jax.random.PRNGKey(0), 32, 96)
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p.items()}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 2.0
    want = r_layers.dense_mlp(p, jnp.asarray(x))
    got = t_layers.dense_mlp(tp, torch.from_numpy(x))
    _close_of_max(got.numpy(), want, OP_RTOL)
    mine = t_layers.init_dense_mlp(torch.Generator().manual_seed(0), 32, 96)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in p.items()}
    assert float(mine["wi"].abs().max()) <= 3 * 32 ** -0.5
    assert float(mine["wo"].abs().max()) <= 3 * 96 ** -0.5


# --------------------------------------------------------------------------- #
# the four SMOKE models
# --------------------------------------------------------------------------- #


def _cfgs(arch, **kw):
    """(reference config, port config) at f32."""
    f32 = dict(dtype=jnp.float32, cache_dtype=jnp.float32)
    return (dataclasses.replace(RC.get_smoke(arch), **f32, **kw),
            dataclasses.replace(TC.get_smoke(arch), dtype=torch.float32,
                                cache_dtype=torch.float32, **kw))


def _pair(r_cfg, t_cfg):
    """(reference model, weights, the port's model holding them): weights
    drawn by the port from seed 0 and carried both ways."""
    tree = params_to_arrays(Model(t_cfg, device="cpu", seed=0))
    return RModel(r_cfg), jax.tree.map(jnp.asarray, tree), model_params_from_arrays(
        t_cfg, tree, device="cpu")


def _inputs(cfg, B=2, S=24, seed=1):
    """Tokens, or ``[B, S, d_model]`` f32 embeddings, from a seed; numpy."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _t(x):
    t = torch.from_numpy(x)
    return t.long() if t.dtype == torch.int32 else t


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_builds_every_counted_parameter(arch, which):
    """The published configs on the meta device and the SMOKEs: the
    parameters number ``param_counts()['total']``, with the reference's
    leaves and shapes (``final_norm.{g, b}`` and ``norm1.{g, b}`` under
    LayerNorm, ``mlp.{wi, wo}`` for the GELU MLP, no ``embed`` with
    embedding inputs)."""
    t_cfg = getattr(TC, "get_config" if which == "CONFIG" else "get_smoke")(arch)
    r_cfg = getattr(RC, "get_config" if which == "CONFIG" else "get_smoke")(arch)
    model = Model(t_cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == t_cfg.param_counts()["total"]
    assert t_cfg.param_counts() == r_cfg.param_counts()
    shapes = {}
    for name, p in model.named_parameters():
        key = name if not name.startswith("blocks.") else "blocks." + name.split(".", 2)[2]
        shapes.setdefault(key, []).append(tuple(p.shape))
    got = {k: ((len(v),) + v[0]) if k.startswith("blocks.") else v[0] for k, v in shapes.items()}
    want = {jax.tree_util.keystr(k).replace("']['", ".").strip("[']"): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(r_cfg.param_shapes())[0]}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_equal_reference(arch):
    r_cfg, t_cfg = _cfgs(arch)
    r_model, params, model = _pair(r_cfg, t_cfg)
    x = _inputs(t_cfg)
    want, _ = jax.jit(r_model.forward)(params, jnp.asarray(x))
    with torch.no_grad():
        got, aux = model(_t(x))
    assert got.shape == (2, 24, t_cfg.vocab_size) and float(aux) == 0.0
    _close_of_max(got.numpy(), want, MODEL_RTOL)


def test_hubert_attends_both_ways():
    """The encoder's attention is bidirectional: changing the last frame
    moves the first frame's logits (a causal model's stay put)."""
    _, t_cfg = _cfgs("hubert-xlarge")
    model = Model(t_cfg, device="cpu", seed=0)
    x = _t(_inputs(t_cfg))
    y = x.clone()
    y[:, -1] = torch.randn(y[:, -1].shape, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        a, b = model(x)[0], model(y)[0]
        causal = Model(dataclasses.replace(t_cfg, causal=True), device="cpu", seed=0)
        c, d = causal(x)[0], causal(y)[0]
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4
    assert torch.equal(c[:, 0], d[:, 0])


def _decode_inputs(cfg, x):
    """(prefill batch of S-1, decode state's input key and value)."""
    key = "tokens" if cfg.embed_inputs else "embeds"
    one = "token" if cfg.embed_inputs else "embed"
    return {key: _t(x[:, :-1])}, one, _t(x[:, -1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(arch):
    """The decoders' prefill of S-1 plus one decode (at ``cache_len`` S-1,
    so a wrong position offset shows) against their forward of S under
    5e-4; every decode, hubert's too (the reference's ``decode_step`` runs
    for the encoder, though ``cells()`` has no decode cell for it), against
    the reference's decode at rtol 1e-4."""
    r_cfg, t_cfg = _cfgs(arch)
    r_model, params, model = _pair(r_cfg, t_cfg)
    x = _inputs(t_cfg)
    S = x.shape[1]
    batch, one, last = _decode_inputs(t_cfg, x)
    _, caches, clen = make_prefill_step(t_cfg, pad_to=S + 4)(model, batch)
    got, new_caches, new_len = make_decode_step(t_cfg)(
        model, {one: last, "caches": caches, "cache_len": clen})
    assert new_len == S and set(new_caches) == {"kv"}
    if arch in DECODERS:
        with torch.no_grad():
            full = model(_t(x))[0][:, -1]
        rel = float((got - full).abs().max()) / float(full.abs().max())
        assert rel < ROUNDTRIP_BAR
    _, r_caches, r_len = jax.jit(r_model.prefill, static_argnames="pad_to")(
        params, jnp.asarray(x[:, :-1]), pad_to=S + 4)
    want, _ = jax.jit(r_model.decode_step)(params, r_caches, jnp.asarray(x[:, -1:]), r_len)
    _close_of_max(got.numpy(), want, MODEL_RTOL)


def _ref_loss_and_grads(r_cfg, params, batch):
    model = RModel(r_cfg)
    return jax.jit(jax.value_and_grad(lambda p: model.loss(p, batch), has_aux=True))(params)


def _loss_batch(cfg):
    x = _inputs(cfg, S=24)
    labels = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels[0, -3:] = -1
    key = "tokens" if cfg.embed_inputs else "embeds"
    return ({key: jnp.asarray(x), "labels": jnp.asarray(labels)},
            {key: _t(x), "labels": torch.from_numpy(labels)})


def _port_loss_and_grads(model, batch):
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.requires_grad_(False)
    return loss.detach(), grads


def _assert_grads(got, want_tree):
    got, want = _flat(params_to_arrays(got)), _flat(want_tree)
    assert got.keys() == want.keys()
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * scale, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_reference(arch):
    r_cfg, t_cfg = _cfgs(arch)
    _, params, model = _pair(r_cfg, t_cfg)
    r_batch, t_batch = _loss_batch(t_cfg)
    (want, _), want_g = _ref_loss_and_grads(r_cfg, params, r_batch)
    loss, grads = _port_loss_and_grads(model, t_batch)
    assert float(loss) == pytest.approx(float(want), rel=LOSS_REL)
    _assert_grads(grads, want_g)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "ef-int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_equal_reference(arch, compress):
    """3 steps of ``make_train_step`` on ``SyntheticPipeline`` batches
    (embeddings for qwen2-vl and hubert, from the same seed in both
    packages), with and without the int8 error-feedback compression."""
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
    r_pipe = RPipeline(r_cfg, 2, 16, seed=3)
    t_pipe = SyntheticPipeline(t_cfg, 2, 16, seed=3, device="cpu")
    lrs = []
    for step in range(3):
        params, r_state, want = r_step(params, r_state, r_pipe.device_batch(step))
        model, t_state, got = t_step(model, t_state, t_pipe.device_batch(step))
        for key in ("loss", "ce", "grad_norm"):
            rel = QUANT_NORM_REL if compress and key == "grad_norm" else LOSS_REL
            assert abs(float(got[key]) - float(want[key])) <= rel * abs(float(want[key])), key
        lrs.append(float(want["lr"]))
    atol = 2 * sum(lrs) + 1e-6
    got, want = _flat(params_to_arrays(model)), _flat(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_roundtrip_is_lossless(arch):
    """The reference's tree (LayerNorm ``{g, b}`` leaves, the GELU MLP's
    ``wi`` and ``wo``, stacked on the leading ``n_groups`` axis) into the
    port and back, bitwise, with the AdamW moments; the int8 error-feedback
    compression of the norm and MLP leaves bitwise the reference's (one
    scale per stacked leaf; eager in the reference: jit lets XLA rewrite
    the division by the scale)."""
    r_cfg, t_cfg = _cfgs(arch)
    tree = jax.tree.map(np.asarray, jax.jit(RModel(r_cfg).init)(jax.random.PRNGKey(2)))
    model = model_params_from_arrays(t_cfg, tree, device="cpu")
    back = params_to_arrays(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    if t_cfg.norm == "ln":
        assert set(tree["final_norm"]) == set(tree["blocks"]["sub0"]["norm1"]) == {"g", "b"}
    if not t_cfg.mlp_gated or t_cfg.norm == "ln":
        assert set(tree["blocks"]["sub0"]["mlp"]) == {"wi", "wo"}
    r_state = jax.tree.map(np.asarray, r_adamw.adamw_init(tree, r_adamw.AdamWConfig()))
    r_state["mu"] = jax.tree.map(lambda a: a - 0.25, r_state["mu"])
    state = adamw_state_from_arrays(r_state, model, device="cpu")
    for a, b in zip(jax.tree.leaves(adamw_state_to_arrays(state)), jax.tree.leaves(r_state)):
        np.testing.assert_array_equal(a, b)
    # the norms' and MLPs' leaves (the others are tests/test_torch_train.py's)
    named = {k: p.detach() * 0.1 + 0.01 for k, p in model.named_parameters()
             if "norm" in k or ".mlp." in k}
    got, err = t_comp.ef_compress(named, t_comp.init_error_state(named))
    sub = {"final_norm": tree["final_norm"],
           "blocks": {"sub0": {k: tree["blocks"]["sub0"][k] for k in ("norm1", "norm2", "mlp")}}}
    rt = jax.tree.map(lambda a: jnp.asarray(a * np.float32(0.1) + np.float32(0.01)), sub)
    want, r_err = r_comp.ef_compress(rt, r_comp.init_error_state(rt))
    for a, b in ((got, want), (err, r_err)):
        g, w = _flat(params_to_arrays(a)), _flat(b)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# --------------------------------------------------------------------------- #
# remat_policy_name="dots"
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["starcoder2-3b", "hubert-xlarge"])
def test_dots_remat_policy_equals_reference_and_nothing(arch):
    """The port's selective checkpoint (``aten.mm`` / ``aten.addmm``
    outputs kept) against the reference's ``jax.checkpoint`` with
    ``dots_with_no_batch_dims_saveable`` at the loss and gradient bars, and
    bitwise against the port's ``"nothing"`` policy; the policy keeps the
    weight products and recomputes the attention's ``bmm``."""
    r_cfg, t_cfg = _cfgs(arch, remat_policy_name="dots")
    assert r_cfg.remat and r_cfg.remat_policy is jax.checkpoint_policies.\
        dots_with_no_batch_dims_saveable
    _, params, model = _pair(r_cfg, t_cfg)
    r_batch, t_batch = _loss_batch(t_cfg)
    (want, _), want_g = _ref_loss_and_grads(r_cfg, params, r_batch)
    loss, grads = _port_loss_and_grads(model, t_batch)
    assert float(loss) == pytest.approx(float(want), rel=LOSS_REL)
    _assert_grads(grads, want_g)
    nothing = model_params_from_arrays(dataclasses.replace(t_cfg, remat_policy_name="nothing"),
                                       params_to_arrays(model), device="cpu")
    loss_n, grads_n = _port_loss_and_grads(nothing, t_batch)
    assert torch.equal(loss, loss_n)
    for k in grads:
        assert torch.equal(grads[k], grads_n[k]), k
    from repro_torch.models import transformer as tf

    ops = torch.ops.aten
    assert tf._dots_policy(None, ops.mm.default) == tf.CheckpointPolicy.MUST_SAVE
    assert tf._dots_policy(None, ops.addmm.default) == tf.CheckpointPolicy.MUST_SAVE
    for op in (ops.bmm.default, ops.gelu.default, ops.exp.default):
        assert tf._dots_policy(None, op) == tf.CheckpointPolicy.PREFER_RECOMPUTE


def test_dots_policy_sees_the_weight_products_as_mm():
    """On the CPU a 3-D ``x @ W`` reaches the dispatcher as ``aten.mm`` and
    the attention's einsum as ``aten.bmm``: what the policy keys on."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    x, w = torch.ones(2, 5, 8), torch.ones(8, 4)
    q, k = torch.ones(2, 1, 3, 5, 4), torch.ones(2, 1, 6, 4)
    with Record():
        x @ w
        torch.einsum("bhgqd,bhkd->bhgqk", q, k)
    assert torch.ops.aten.mm.default in seen and torch.ops.aten.bmm.default in seen


@pytest.mark.parametrize("arch", ["starcoder2-3b", "hubert-xlarge"])
def test_dots_keeps_the_weight_products(arch, monkeypatch):
    """``"dots"`` saves what ``"nothing"`` recomputes.  Counting the weight
    products (``aten.mm`` / ``aten.addmm``) of each call of
    ``apply_group`` over one loss and backward (a group's first call is its
    forward, the second the checkpoint's recomputation in the backward):
    the forwards run the same products under both policies, the
    recomputation runs none under ``"dots"`` (it takes the saved outputs)
    and some under ``"nothing"``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import transformer as tf

    products = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in products
            return func(*args, **(kwargs or {}))

    _, t_cfg = _cfgs(arch)
    batch = _loss_batch(t_cfg)[1]
    weights = params_to_arrays(Model(t_cfg, device="cpu", seed=0))
    inner, calls = tf.apply_group, {}
    for policy in ("dots", "nothing"):
        model = model_params_from_arrays(
            dataclasses.replace(t_cfg, remat_policy_name=policy), weights, device="cpu")
        per_call = calls[policy] = []

        def counted_group(*args, **kwargs):
            n0 = mode.n
            try:
                return inner(*args, **kwargs)
            finally:  # a recomputation stops early by raising
                per_call.append(mode.n - n0)

        monkeypatch.setattr(tf, "apply_group", counted_group)
        with Count() as mode:
            _port_loss_and_grads(model, batch)
    g = t_cfg.n_groups
    assert len(calls["dots"]) == len(calls["nothing"]) == 2 * g, calls
    assert calls["dots"][:g] == calls["nothing"][:g] and min(calls["dots"][:g]) > 0, calls
    assert calls["dots"][g:] == [0] * g and min(calls["nothing"][g:]) > 0, calls


# --------------------------------------------------------------------------- #
# input_specs and the roofline terms
# --------------------------------------------------------------------------- #

_DTYPES = {torch.int32: jnp.int32, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return tuple(tree.shape), jnp.dtype(_DTYPES[tree.dtype])
    return tuple(tree.shape), jnp.dtype(tree.dtype)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_input_specs_equal_reference_for_every_runnable_cell(arch):
    """Every runnable (arch, shape) cell of ``cells()`` at the published
    configs: the same tree, shapes and dtypes, as meta tensors (decode
    caches from a meta model's ``init_caches``: nothing allocated)."""
    cells = [c for c in RC.cells() if c["arch"] == arch and c["runnable"]]
    assert cells and TC.cells() == RC.cells()
    for c in cells:
        r_cfg, t_cfg = RC.get_config(arch, c["shape"]), TC.get_config(arch, c["shape"])
        for batch in (None, 3):
            want = RC.input_specs(r_cfg, RC.SHAPES[c["shape"]], batch_override=batch)
            got = TC.input_specs(t_cfg, TC.SHAPES[c["shape"]], batch_override=batch)
            assert _spec_tree(got) == _spec_tree(want), (c, batch)
    with pytest.raises(ValueError):
        TC.input_specs(TC.get_smoke(arch), TC.Shape("x", "eval", 8, 1))


_GRID = list(itertools.product((0.0, 1e12, 3.7e15), (0.0, 2.5e9), (0.0, 6e8),
                               (0.0, 9e11), (1, 4)))


@pytest.mark.parametrize("hw", ["tpu_v5e", "h100_sxm"])
def test_roofline_terms_equal_reference(hw):
    """``roofline_terms(...).as_dict()`` on a grid with zero FLOPs, bytes
    and collective bytes, under the reference's TPU v5e and the port's H100
    constants (the reference given the same numbers)."""
    t_hw = T.TPU_V5E if hw == "tpu_v5e" else T.H100_SXM
    r_hw = r_tracer.HardwareModel(t_hw.name, t_hw.peak_flops, t_hw.hbm_gbps, t_hw.ici_gbps)
    raised = 0
    for args in _GRID:
        try:
            want = r_roof.roofline_terms(*args, hw=r_hw).as_dict()
        except ZeroDivisionError:
            # zero FLOPs under a non-zero bound: the reference's
            # roofline_fraction divides by zero, and so does the port's
            with pytest.raises(ZeroDivisionError):
                T.roofline_terms(*args, hw=t_hw).as_dict()
            raised += 1
            continue
        got = T.roofline_terms(*args, hw=t_hw).as_dict()
        assert got == want, args
    assert 0 < raised < len(_GRID)
    assert T.roofline_terms(1.0, 1.0, 1.0, 1.0, 1).as_dict() == r_roof.roofline_terms(
        1.0, 1.0, 1.0, 1.0, 1, hw=r_tracer.HardwareModel(
            "h100_sxm", 989e12, 3350.0, 450.0)).as_dict()
    assert isinstance(T.roofline_terms(*_GRID[-1]), T.RooflineTerms)
