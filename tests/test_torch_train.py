"""Port parity: training.  ``repro_torch``'s ``Model.loss`` and its
gradients, AdamW, the cosine schedule, clipping, int8 error-feedback
compression, ``make_train_step`` and ``train_loop`` against ``repro``'s, on
the same weights (carried across with ``repro_torch.interop``) and the same
``SyntheticPipeline`` batches, at f32 on the CPU.

Tolerances:
- the loss: rel 1e-5 (the same f32 function; the port sums the
  cross-entropy per head chunk, then over chunks);
- gradients: rtol 1e-4 plus atol 1e-4 of the largest gradient element of
  the model.  Per leaf, mamba2's layer-0 ``in_proj`` columns for B and C
  part by up to 1.7e-4 of that leaf's largest element: there the SSD
  backward is ill-conditioned in f32, and each package's f32 gradient
  misses an f64 run of the same function by 8-9e-5 of it;
- ``adamw_update``, the schedule and clipping on identical inputs: rtol
  1e-6, plus atol 1e-6 of a leaf's largest element where an update
  cancels most of a value (a new parameter ``p - lr * delta`` near 0 keeps
  the rounding of ``p``'s scale); compression: bitwise (both round half to
  even);
- with int8 compression the gradient norm: rel 1e-4 (an element within
  f32 noise of a rounding boundary takes the neighbouring level);
- after 3 train steps the parameters: within ``2 * sum(lr)`` plus 1e-6.
  AdamW's first update is about ``lr * sign(g)``, so a gradient element
  near 0 whose sign differs between the packages moves a parameter by up
  to ``2 * lr``; the gradients themselves are held above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_2_7b as r_m2cfg
from repro.configs import qwen3_0_6b as r_q3cfg
from repro.data.pipeline import SyntheticPipeline as RPipeline
from repro.launch.steps import abstract_train_state as r_abstract
from repro.launch.steps import make_train_step as r_make_train_step
from repro.launch.train import train_loop as r_train_loop
from repro.models import Model as RModel
from repro.models import ModelConfig as RConfig
from repro.optim import adamw as r_adamw
from repro.optim import compression as r_comp
from repro_torch.configs import mamba2_2_7b as t_m2cfg
from repro_torch.configs import qwen3_0_6b as t_q3cfg
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.interop import (
    adamw_state_from_arrays,
    adamw_state_to_arrays,
    model_params_from_arrays,
    params_to_arrays,
)
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.launch.steps import (
    abstract_train_state,
    make_prefill_step,
    make_train_step,
)
from repro_torch.launch.train import train_loop
from repro_torch.models import Model, ModelConfig
from repro_torch.models import model as t_model_mod
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp

torch.set_num_threads(2)

LOSS_REL = 1e-5
GRAD_RTOL = GRAD_ATOL_OF_MAX = 1e-4
UPDATE_RTOL = 1e-6
QUANT_NORM_REL = 1e-4  # the gradient norm after int8 compression (one level flips)

# tests/test_train_integration.py's TINY, in both packages
R_TINY = RConfig(
    name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, dtype=jnp.float32, cache_dtype=jnp.float32, remat=False,
)
T_TINY = ModelConfig(
    name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, dtype=torch.float32, cache_dtype=torch.float32, remat=False,
)
SMOKES = {"qwen3": (r_q3cfg.SMOKE, t_q3cfg.SMOKE), "mamba2": (r_m2cfg.SMOKE, t_m2cfg.SMOKE)}


def _f32(r_cfg, t_cfg):
    return (dataclasses.replace(r_cfg, dtype=jnp.float32, cache_dtype=jnp.float32),
            dataclasses.replace(t_cfg, dtype=torch.float32, cache_dtype=torch.float32))


def _pair(r_cfg, t_cfg, seed=0):
    """(reference model, its params, the port's model holding them)."""
    r_model = RModel(r_cfg)
    params = r_model.init(jax.random.PRNGKey(seed))
    t_model = model_params_from_arrays(t_cfg, jax.tree.map(np.asarray, params), device="cpu")
    return r_model, params, t_model


def _batch(vocab, B=2, S=32, seed=1):
    """Tokens and next-token labels, a few labels masked."""
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -3:] = -1
    return toks[:, :-1], labels


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_loss_and_grads(model, toks, labels):
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    loss, parts = model.loss({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return loss.detach(), parts, grads


def _assert_grads_close(got_tree, want_tree):
    got, want = _flat(got_tree), _flat(want_tree)
    assert got.keys() == want.keys()
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * scale, err_msg=k)


# --------------------------------------------------------------------------- #
# Model.loss
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("chunk", [7, 4096], ids=["chunked-head", "one-chunk"])
@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_loss_and_gradients_equal_reference(arch, chunk, monkeypatch):
    """mamba2's gradients flow through the plain chunked SSD's autograd."""
    monkeypatch.setattr(t_model_mod, "HEAD_CHUNK_TOKENS", chunk)
    r_cfg, t_cfg = _f32(*SMOKES[arch])
    r_model, params, t_model = _pair(r_cfg, t_cfg)
    toks, labels = _batch(r_cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (want, want_parts), want_g = jax.value_and_grad(
        lambda p: r_model.loss(p, batch), has_aux=True)(params)
    got, parts, grads = _port_loss_and_grads(t_model, toks, labels)
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
    ce = float(parts["ce"].detach())
    assert abs(ce - float(want_parts["ce"])) <= LOSS_REL * float(want_parts["ce"])
    assert float(parts["aux"]) == float(want_parts["aux"]) == 0.0
    _assert_grads_close(params_to_arrays(grads), want_g)


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_chunked_head_equals_unchunked(arch, monkeypatch):
    """The chunked head against the whole batch's logits at once (the
    reference's form, from the port's own forward): loss and gradients."""
    monkeypatch.setattr(t_model_mod, "HEAD_CHUNK_TOKENS", 5)
    t_cfg = _f32(*SMOKES[arch])[1]
    model = Model(t_cfg, device="cpu", seed=0)
    toks, labels = _batch(t_cfg.vocab_size)
    got, _, got_g = _port_loss_and_grads(model, toks, labels)
    model.zero_grad(set_to_none=True)
    logits, aux = model(torch.from_numpy(toks))
    lab = torch.from_numpy(labels).long()
    logp = torch.log_softmax(logits.float(), -1)
    valid = lab >= 0
    ll = logp.gather(-1, torch.where(valid, lab, 0)[..., None])[..., 0]
    want = -(ll * valid).sum() / valid.sum() + 0.01 * aux
    want.backward()
    want = float(want.detach())
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    for k, p in model.named_parameters():
        torch.testing.assert_close(got_g[k], p.grad, rtol=1e-5, atol=1e-6 * float(p.grad.abs().max()))


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_remat_recomputes_exactly(arch):
    """Activation recomputation changes nothing: loss and gradients bitwise
    with ``remat`` on and off."""
    t_cfg = _f32(*SMOKES[arch])[1]
    toks, labels = _batch(t_cfg.vocab_size)
    out = []
    for remat in (True, False):
        model = Model(dataclasses.replace(t_cfg, remat=remat), device="cpu", seed=0)
        out.append(_port_loss_and_grads(model, toks, labels))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][2]:
        assert torch.equal(out[0][2][k], out[1][2][k]), k


def test_dots_remat_policy_is_refused():
    """``remat_policy_name="dots"`` is ported (the reference's
    ``dots_with_no_batch_dims_saveable``; held against it in
    tests/test_torch_vlm_audio.py): keeping the weight products changes
    nothing, loss and gradients bitwise the ``"nothing"`` policy's; an
    unknown policy is refused."""
    t_cfg = _f32(*SMOKES["qwen3"])[1]
    toks, labels = _batch(t_cfg.vocab_size)
    out = []
    for policy in ("dots", "nothing"):
        model = Model(dataclasses.replace(t_cfg, remat_policy_name=policy), device="cpu",
                      seed=0)
        out.append(_port_loss_and_grads(model, toks, labels))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][2]:
        assert torch.equal(out[0][2][k], out[1][2][k]), k
    with pytest.raises(ValueError, match="unknown remat policy"):
        dataclasses.replace(t_q3cfg.SMOKE, remat_policy_name="offload")


def test_padded_vocab_loss_equals_unpadded():
    """tests/test_vocab_padding.py's contract in the port, and both padded
    losses against the reference's."""
    base_r = dict(name="vp", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                  d_ff=64, vocab_size=101, remat=False)
    r0 = RConfig(**base_r, dtype=jnp.float32, cache_dtype=jnp.float32)
    rp = dataclasses.replace(r0, pad_vocab_to_multiple=16)
    t0 = ModelConfig(**base_r, dtype=torch.float32, cache_dtype=torch.float32)
    tp = dataclasses.replace(t0, pad_vocab_to_multiple=16)
    assert tp.padded_vocab == 112
    r_model, params, m0 = _pair(r0, t0)
    tree = jax.tree.map(np.asarray, params)
    padded = dict(tree, embed=np.concatenate([tree["embed"], np.full((11, 32), 0.5, np.float32)]))
    mp = model_params_from_arrays(tp, padded, device="cpu")
    toks, labels = _batch(101, S=16)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        l0, lp = float(m0.loss(batch)[0]), float(mp.loss(batch)[0])
    assert abs(l0 - lp) <= 1e-6 * l0
    want, _ = RModel(rp).loss(jax.tree.map(jnp.asarray, padded),
                              {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    assert abs(lp - float(want)) <= LOSS_REL * float(want)


# --------------------------------------------------------------------------- #
# the optimizer and compression on identical arrays
# --------------------------------------------------------------------------- #


def _named_tree(seed, scale=1.0):
    """The same values as the port's named tensors (two groups of blocks)
    and as the reference's stacked tree."""
    rng = np.random.default_rng(seed)
    named = {
        "embed": rng.normal(size=(16, 8)) * scale,
        "final_norm": rng.normal(size=(8,)) * scale,
        "blocks.0.sub0.mlp.wi": rng.normal(size=(8, 12)) * scale,
        "blocks.1.sub0.mlp.wi": rng.normal(size=(8, 12)) * scale,
        "blocks.0.sub0.norm1": rng.normal(size=(8,)) * scale,
        "blocks.1.sub0.norm1": rng.normal(size=(8,)) * scale,
    }
    named = {k: torch.from_numpy(v.astype(np.float32)) for k, v in named.items()}
    return named, jax.tree.map(jnp.asarray, params_to_arrays(named))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 50, 99, 100, 120])
def test_cosine_schedule_equals_reference(step):
    r_cfg = r_adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    t_cfg = t_adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    want = float(r_adamw.cosine_schedule(r_cfg, jnp.asarray(step, jnp.int32)))
    got = float(t_adamw.cosine_schedule(t_cfg, torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=UPDATE_RTOL, abs=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_global_norm_and_clipping_equal_reference(max_norm):
    named, tree = _named_tree(3)
    want_clipped, want_n = r_adamw.clip_by_global_norm(tree, max_norm)
    got_clipped, got_n = t_adamw.clip_by_global_norm(named, max_norm)
    assert float(got_n) == pytest.approx(float(want_n), rel=UPDATE_RTOL)
    assert float(t_adamw.global_norm(named)) == pytest.approx(
        float(r_adamw.global_norm(tree)), rel=UPDATE_RTOL)
    got, want = _flat(params_to_arrays(got_clipped)), _flat(want_clipped)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=UPDATE_RTOL, err_msg=k)


@pytest.mark.parametrize("grad_clip", [1.0, 0.0], ids=["clip", "no-clip"])
@pytest.mark.parametrize("steps_before", [0, 4])
def test_adamw_update_equals_reference(steps_before, grad_clip):
    """One update from identical parameters, gradients and moments (at step
    0, and after 4 steps with live moments)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=grad_clip)
    r_cfg, t_cfg = r_adamw.AdamWConfig(**kw), t_adamw.AdamWConfig(**kw)
    named, tree = _named_tree(0)
    grads, g_tree = _named_tree(1, scale=0.3)
    mu, mu_tree = _named_tree(2, scale=0.01)
    nu, nu_tree = _named_tree(4, scale=0.01)
    nu = {k: v.square() for k, v in nu.items()}
    nu_tree = jax.tree.map(jnp.square, nu_tree)
    r_state = {"mu": mu_tree, "nu": nu_tree, "step": jnp.asarray(steps_before, jnp.int32)}
    t_state = {"mu": mu, "nu": nu, "step": torch.tensor(steps_before, dtype=torch.int32)}
    want_p, want_s, want_m = r_adamw.adamw_update(tree, g_tree, r_state, r_cfg)
    _, got_s, got_m = t_adamw.adamw_update(named, grads, t_state, t_cfg)
    assert int(got_s["step"]) == int(want_s["step"]) == steps_before + 1
    for key in ("lr", "grad_norm"):
        assert float(got_m[key]) == pytest.approx(float(want_m[key]), rel=UPDATE_RTOL)
    for got, want in ((named, want_p), (got_s["mu"], want_s["mu"]), (got_s["nu"], want_s["nu"])):
        g, w = _flat(params_to_arrays(got)), _flat(want)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=UPDATE_RTOL,
                                       atol=UPDATE_RTOL * float(np.abs(w[k]).max()), err_msg=k)


def test_adamw_keeps_moment_dtype():
    named, _ = _named_tree(0)
    cfg = t_adamw.AdamWConfig(moment_dtype=torch.bfloat16)
    state = t_adamw.adamw_init(named, cfg)
    grads, _ = _named_tree(1)
    _, state, _ = t_adamw.adamw_update(named, grads, state, cfg)
    assert all(v.dtype == torch.bfloat16 for v in state["mu"].values())
    assert all(v.dtype == torch.bfloat16 for v in state["nu"].values())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1


def test_ef_compression_is_bitwise_the_reference():
    """Three rounds of error-feedback compression carrying the residual, and
    compress_tree / decompress_tree, on identical arrays."""
    named, tree = _named_tree(5)
    err, r_err = t_comp.init_error_state(named), r_comp.init_error_state(tree)
    for _ in range(3):
        got, err = t_comp.ef_compress(named, err)
        want, r_err = r_comp.ef_compress(tree, r_err)
        for a, b in ((got, want), (err, r_err)):
            g, w = _flat(params_to_arrays(a)), _flat(b)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    packed, r_packed = t_comp.compress_tree(named), r_comp.compress_tree(tree)
    g, w = _flat(params_to_arrays(packed["q"])), _flat(r_packed["q"])
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])
        assert g[k].dtype == np.int8
    g, w = (_flat(params_to_arrays(t_comp.decompress_tree(packed))),
            _flat(r_comp.decompress_tree(r_packed)))
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])


# --------------------------------------------------------------------------- #
# the train step and the loop
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "ef-int8"])
def test_tiny_train_steps_equal_reference(compress):
    """3 steps of ``make_train_step`` on TINY from carried weights and
    ``SyntheticPipeline`` batches: losses, the schedule, the gradient norm,
    and the parameters after the steps; uncompressed, the first moments."""
    kw = dict(lr=3e-3, total_steps=10, warmup_steps=1)
    r_opt, t_opt = r_adamw.AdamWConfig(**kw), t_adamw.AdamWConfig(**kw)
    r_model, params, model = _pair(R_TINY, T_TINY)
    r_state = {"adam": r_adamw.adamw_init(params, r_opt),
               "ef": r_comp.init_error_state(params) if compress else {}}
    t_state = {"adam": t_adamw.adamw_init(model, t_opt),
               "ef": t_comp.init_error_state(model) if compress else {}}
    r_step = jax.jit(r_make_train_step(R_TINY, r_opt, compress_grads=compress))
    t_step = make_train_step(T_TINY, t_opt, compress_grads=compress, device="cpu")
    r_pipe, t_pipe = RPipeline(R_TINY, 4, 32, seed=3), SyntheticPipeline(T_TINY, 4, 32, seed=3,
                                                                        device="cpu")
    lrs = []
    for step in range(3):
        params, r_state, want = r_step(params, r_state, r_pipe.device_batch(step))
        model, t_state, got = t_step(model, t_state, t_pipe.device_batch(step))
        for key in ("loss", "ce", "grad_norm"):
            # compressed, the norm is of int8 levels: an element within f32
            # noise of a rounding boundary takes the neighbouring level in
            # the other package (3.2e-5 of the norm seen on TINY)
            rel = QUANT_NORM_REL if compress and key == "grad_norm" else LOSS_REL
            assert abs(float(got[key]) - float(want[key])) <= rel * abs(float(want[key])), key
        assert float(got["lr"]) == pytest.approx(float(want["lr"]), rel=UPDATE_RTOL)
        lrs.append(float(want["lr"]))
    assert all(p.grad is None for p in model.parameters())
    atol = 2 * sum(lrs) + 1e-6
    got, want = _flat(params_to_arrays(model)), _flat(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
    got_adam = adamw_state_to_arrays(t_state["adam"])
    assert int(got_adam["step"]) == int(r_state["adam"]["step"]) == 3
    if compress:
        return  # an element's int8 level may flip (see above), and its moment with it
    # the first moments are gradient sums, held like the gradients
    g, w = _flat(got_adam["mu"]), _flat(r_state["adam"]["mu"])
    scale = max(float(np.abs(v).max()) for v in w.values())
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=GRAD_RTOL, atol=GRAD_ATOL_OF_MAX * scale,
                                   err_msg=k)


def test_train_loop_loss_decreases():
    out = train_loop(T_TINY, steps=30, batch=4, seq=32, lr=3e-3, log_every=0, device="cpu")
    assert len(out["losses"]) == 30
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first, f"loss did not decrease: {first:.3f} -> {last:.3f}"


def test_train_loop_resumes_after_the_step_5_checkpoint(tmp_path):
    d = str(tmp_path)
    train_loop(T_TINY, steps=10, batch=2, seq=16, ckpt_dir=d, ckpt_interval=5, log_every=0,
               device="cpu")
    out = train_loop(T_TINY, steps=14, batch=2, seq=16, ckpt_dir=d, ckpt_interval=5,
                     log_every=0, device="cpu")
    assert out["start_step"] == 6  # resumed after the step-5 checkpoint
    assert out["steps"] == 8 and len(out["losses"]) == 8
    assert out["stragglers"] == [] or all("ewma_s" in e for e in out["stragglers"])


def test_train_loop_simulated_like_the_reference():
    """simulate=True: the same summary keys and epochs as the reference's
    loop, and the simulated time at least the native time."""
    got = train_loop(T_TINY, steps=5, batch=2, seq=16, simulate=True, log_every=0,
                     device="cpu")
    want = r_train_loop(R_TINY, steps=5, batch=2, seq=16, simulate=True, log_every=0)
    assert set(got["sim"]) == set(want["sim"])
    assert got["sim"]["epochs"] == want["sim"]["epochs"] == 5
    assert got["sim"]["steps"] == 5
    assert got["sim"]["simulated_s"] >= got["sim"]["native_s"]


# --------------------------------------------------------------------------- #
# state, refusals and serving after training
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_abstract_train_state_matches_the_reference(arch):
    r_cfg, t_cfg = SMOKES[arch]
    r_params, r_opt = r_abstract(r_cfg, r_adamw.AdamWConfig(), compress_grads=True)
    model, opt = abstract_train_state(t_cfg, t_adamw.AdamWConfig(), compress_grads=True)
    tensors = [*model.parameters(), *opt["adam"]["mu"].values(), *opt["adam"]["nu"].values(),
               *opt["ef"].values(), opt["adam"]["step"]]
    assert all(t.device.type == "meta" for t in tensors)
    shapes = {}
    for name, p in model.named_parameters():
        key = name if not name.startswith("blocks.") else "blocks." + name.split(".", 2)[2]
        shapes.setdefault(key, []).append(tuple(p.shape))
    got = {k: ((len(v),) + v[0]) if k.startswith("blocks.") else v[0] for k, v in shapes.items()}
    want = {jax.tree_util.keystr(k).replace("']['", ".").strip("[']"): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(r_params)[0]}
    assert got == want
    assert len(opt["adam"]["mu"]) == len(opt["ef"]) == len(list(model.parameters()))
    assert r_opt["adam"]["step"].shape == tuple(opt["adam"]["step"].shape) == ()


def test_ssm_training_is_refused_on_the_card_before_any_work():
    opt = t_adamw.AdamWConfig()
    with pytest.raises(NotImplementedError, match="SSD backward kernel"):
        make_train_step(t_m2cfg.CONFIG, opt)
    with pytest.raises(NotImplementedError, match="SSD backward kernel"):
        make_train_step(t_m2cfg.SMOKE, opt, device="cuda")
    make_train_step(t_m2cfg.SMOKE, opt, device="cpu")  # the plain path trains


def test_kernel_entry_points_refuse_a_backward_off_the_cpu():
    """Off the CPU (meta tensors here stand for the card's) an input that
    requires grad is refused before any launch; without autograd recording
    the call goes on to the device dispatch."""
    x = torch.zeros(1, 8, 1, 4, device="meta", requires_grad=True)
    dt, bm = torch.zeros(1, 8, 1, device="meta"), torch.zeros(1, 8, 2, device="meta")
    q = torch.zeros(1, 2, 8, 32, device="meta", requires_grad=True)
    kv = torch.zeros(1, 2, 8, 32, device="meta")
    counts = (t_ops.plain_launches, t_ssd.ssd_launches, t_flash.flash_launches)
    with pytest.raises(NotImplementedError, match="SSD backward kernel"):
        t_ops.ssd(x, dt, torch.ones(1, device="meta"), bm, bm)
    with pytest.raises(NotImplementedError, match="flash attention backward kernel"):
        t_ops.attention(q, kv, kv)
    with torch.no_grad():
        with pytest.raises(ValueError, match="no ssd for tensors on meta"):
            t_ops.ssd(x, dt, torch.ones(1, device="meta"), bm, bm)
        with pytest.raises(ValueError, match="no attention for tensors on meta"):
            t_ops.attention(q, kv, kv)
    assert (t_ops.plain_launches, t_ssd.ssd_launches, t_flash.flash_launches) == counts
    # the CPU's plain versions stay differentiable
    xc = torch.randn(1, 8, 1, 4, requires_grad=True)
    t_ops.ssd(xc, torch.full((1, 8, 1), 0.1), -torch.ones(1), torch.randn(1, 8, 2),
              torch.randn(1, 8, 2), chunk=4).sum().backward()
    assert xc.grad is not None and bool(xc.grad.abs().sum() > 0)


def test_serving_a_trained_model_builds_no_graph():
    opt = t_adamw.AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    model = Model(T_TINY, device="cpu", seed=0)
    assert not any(p.requires_grad for p in model.parameters())  # built for serving
    state = {"adam": t_adamw.adamw_init(model, opt), "ef": {}}
    model, state, m = make_train_step(T_TINY, opt, device="cpu")(
        model, state, SyntheticPipeline(T_TINY, 2, 16, device="cpu").device_batch(0))
    assert all(p.requires_grad for p in model.parameters())
    toks = torch.zeros(2, 8, dtype=torch.long)
    logits, caches, _ = make_prefill_step(T_TINY, pad_to=9)(model, {"tokens": toks})
    assert not logits.requires_grad and logits.grad_fn is None
    logits, caches, clen = model.prefill(toks, pad_to=9)  # the model's own entry too
    out, _ = model.decode_step(caches, toks[:, :1], clen)
    assert not out.requires_grad and out.grad_fn is None


def test_interop_carries_params_and_adamw_state_both_ways():
    r_cfg, t_cfg = _f32(*SMOKES["qwen3"])
    _, params, model = _pair(r_cfg, t_cfg)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_arrays(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    r_opt = r_adamw.AdamWConfig()
    r_state = jax.tree.map(np.asarray, r_adamw.adamw_init(params, r_opt))
    r_state["mu"] = jax.tree.map(lambda a: a + 0.25, r_state["mu"])
    r_state["step"] = np.asarray(7, np.int32)
    state = adamw_state_from_arrays(r_state, model, device="cpu")
    assert int(state["step"]) == 7 and state["step"].dtype == torch.int32
    assert set(state["mu"]) == {k for k, _ in model.named_parameters()}
    again = adamw_state_to_arrays(state)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(r_state)):
        np.testing.assert_array_equal(a, b)
