"""Port parity: attention.  The port's plain flash-kernel version
(``repro_torch.kernels.ref.mha_attention``) against the reference's plain
version and its Pallas kernel in interpret mode on the reference's own test
cases; the decode kernel's split-KV arithmetic
(``ref.split_kv_attention``) against the reference's plain version on
decode shapes; the model's chunked attention, RoPE and qk-norm against
``repro.models.attention``; the device dispatch of ``ops.attention``, the
wrapper's choice of kernel and of KV splits, and the CUDA wrapper's
refusals on the CPU.  Inputs are made from a seed with numpy and handed to
both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.models import attention as r_attn
from repro.models.layers import rms_norm as r_rms_norm
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import attention as t_attn
from repro_torch.models.layers import rms_norm as t_rms_norm

torch.set_num_threads(2)

ATTN_CASES = [  # tests/test_kernels.py's cases: B, H, Hk, Sq, Sk, D, causal, q_offset
    (1, 4, 2, 256, 256, 64, True, 0),
    (2, 8, 2, 128, 128, 32, False, 0),
    (1, 2, 2, 128, 512, 64, True, 384),  # decode tail with cache
    (1, 16, 8, 512, 512, 128, True, 0),
    (2, 4, 4, 256, 256, 128, True, 0),  # MHA (no GQA)
]
IDS = [str(c) for c in ATTN_CASES]
F32_TOL = 2e-5  # tests/test_kernels.py's bar for the flash kernel
BF16_TOL = 2e-2  # its bf16 bar: each side rounds nearly equal f32 values once


def _qkv(B, H, Hk, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hk, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Hk, Sk, D)).astype(np.float32))


def _both(arrays, r_dtype=jnp.float32, t_dtype=torch.float32):
    return ([jnp.asarray(a, r_dtype) for a in arrays],
            [torch.from_numpy(a).to(t_dtype) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------------------- #
# the flash kernel's plain version
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ATTN_CASES, ids=IDS)
def test_plain_mha_matches_reference_mha(case):
    B, H, Hk, Sq, Sk, D, causal, qoff = case
    r_in, t_in = _both(_qkv(B, H, Hk, Sq, Sk, D, seed=B * Sq + D))
    want = r_ref.mha_attention(*r_in, causal=causal, q_offset=qoff)
    got = t_ref.mha_attention(*t_in, causal=causal, q_offset=qoff)
    assert got.dtype == torch.float32 and got.shape == (B, H, Sq, D)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", ATTN_CASES, ids=IDS)
def test_plain_mha_matches_pallas_interpret(case):
    B, H, Hk, Sq, Sk, D, causal, qoff = case
    r_in, t_in = _both(_qkv(B, H, Hk, Sq, Sk, D, seed=B * Sq + D))
    want = r_flash(*r_in, q_offset=qoff, causal=causal, block_q=128, block_k=128,
                   interpret=True)
    got = t_ref.mha_attention(*t_in, causal=causal, q_offset=qoff)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("which", ["reference", "pallas_interpret"])
def test_plain_mha_keeps_bf16(which):
    """tests/test_kernels.py's dtype case: bf16 in, bf16 out, within 2e-2."""
    r_in, t_in = _both(_qkv(1, 4, 2, 128, 128, 64, seed=0), jnp.bfloat16, torch.bfloat16)
    if which == "reference":
        want = r_ref.mha_attention(*r_in)
    else:
        want = r_flash(*r_in, block_q=128, block_k=128, interpret=True)
    got = t_ref.mha_attention(*t_in)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_TOL, atol=BF16_TOL)


def test_plain_mha_scale_and_gqa_head_map():
    """An explicit scale, and query head h reading KV head h // (H / Hk):
    each group of query heads equals MHA over its one KV head."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 6, 2, 16, 24, 32, seed=3))
    got = t_ref.mha_attention(q, k, v, causal=True, scale=0.3, q_offset=8)
    for h in range(6):
        one = t_ref.mha_attention(q[:, h:h + 1], k[:, h // 3:h // 3 + 1],
                                  v[:, h // 3:h // 3 + 1], causal=True, scale=0.3, q_offset=8)
        torch.testing.assert_close(got[:, h:h + 1], one, rtol=0.0, atol=1e-6)
    with pytest.raises(ValueError, match="H % Hk"):
        t_ref.mha_attention(q[:, :5], k, v)


# --------------------------------------------------------------------------- #
# the decode kernel's split-KV arithmetic
# --------------------------------------------------------------------------- #

DECODE = [  # B, H, Hk, Sk, D, split_len: GQA 2:1 and 1:1, ragged and whole splits
    (2, 4, 2, 300, 32, 64),
    (1, 2, 2, 256, 64, 128),
    (2, 8, 4, 129, 32, 32),
]


@pytest.mark.parametrize("case", DECODE, ids=[str(c) for c in DECODE])
def test_split_kv_attention_matches_reference_mha_at_every_cache_length(case):
    """Sq = 1 at q_offset 0 .. Sk - 1 over a padded cache: the splits past
    the visible keys (all but the first at q_offset 0) add nothing, and the
    merged splits equal the reference's softmax at its f32 bar."""
    B, H, Hk, Sk, D, split_len = case
    r_in, t_in = _both(_qkv(B, H, Hk, 1, Sk, D, seed=Sk + D))
    for qoff in sorted({0, 1, split_len - 1, split_len, split_len + 1, Sk // 2, Sk - 2, Sk - 1}):
        want = r_ref.mha_attention(*r_in, causal=True, q_offset=qoff)
        got = t_ref.split_kv_attention(*t_in, split_len, causal=True, q_offset=qoff)
        assert got.dtype == torch.float32 and got.shape == (B, H, 1, D)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=f"q_offset={qoff}")


@pytest.mark.parametrize("causal", [True, False])
def test_split_kv_attention_matches_reference_mha_for_a_few_queries(causal):
    """Sq = 4 (rows at different causal horizons) and without causality."""
    r_in, t_in = _both(_qkv(2, 4, 2, 4, 200, 64, seed=21))
    want = r_ref.mha_attention(*r_in, causal=causal, q_offset=130)
    got = t_ref.split_kv_attention(*t_in, 64, causal=causal, q_offset=130)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=F32_TOL, atol=F32_TOL)


def test_split_kv_attention_gives_zero_where_a_row_sees_no_key():
    """q_offset = -2: rows 0 and 1 see no key (the reference's plain version
    is NaN there, the kernels return 0); rows 2 and 3 see keys 0 and 0..1."""
    _, t_in = _both(_qkv(1, 2, 1, 4, 100, 32, seed=4))
    got = t_ref.split_kv_attention(*t_in, 32, causal=True, q_offset=-2)
    assert torch.equal(got[:, :, :2], torch.zeros_like(got[:, :, :2]))
    want = t_ref.mha_attention(*t_in, causal=True, q_offset=-2)
    assert bool(torch.isnan(want[:, :, :2]).all())
    torch.testing.assert_close(got[:, :, 2:], want[:, :, 2:], rtol=F32_TOL, atol=F32_TOL)


def test_split_kv_attention_at_the_wrappers_splits_on_the_served_decode_shape():
    """qwen3-0.6b's decode (H = 16, Hk = 8, D = 128, a 4112-slot cache,
    q_offset = 4096), batch cut to 1: the splits the wrapper picks."""
    split_len, n_splits = t_flash.decode_splits(8, 8, 1, 4112, 4096, True)
    assert (split_len, n_splits) == (896, 5)
    r_in, t_in = _both(_qkv(1, 16, 8, 1, 4112, 128, seed=9))
    want = r_ref.mha_attention(*r_in, causal=True, q_offset=4096)
    got = t_ref.split_kv_attention(*t_in, split_len, causal=True, q_offset=4096)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=F32_TOL, atol=F32_TOL)


# --------------------------------------------------------------------------- #
# the model's chunked attention, RoPE and qk-norm
# --------------------------------------------------------------------------- #

CHUNKED = [  # B, H, Hk, Sq, Sk, causal, q_offset, window, blocks
    (2, 4, 2, 72, 72, True, 0, None, 32),  # several blocks, ragged edges padded
    (2, 4, 2, 72, 72, False, 0, None, 32),
    (1, 4, 4, 64, 64, True, 0, 24, 16),  # sliding window
    (2, 4, 1, 24, 88, True, 64, None, 32),  # queries at absolute positions 64..87
    (1, 4, 2, 40, 40, True, 0, None, 1024),  # one block (blocks cut to the sequence)
]


@pytest.mark.parametrize("case", CHUNKED, ids=[str(c) for c in CHUNKED])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_attention_matches_reference(case, dtype):
    B, H, Hk, Sq, Sk, causal, qoff, window, blk = case
    arrays = _qkv(B, H, Hk, Sq, Sk, 32, seed=Sq + Sk)
    if dtype == "f32":
        r_in, t_in = _both(arrays)
    else:
        r_in, t_in = _both(arrays, jnp.bfloat16, torch.bfloat16)
    kw = dict(causal=causal, q_offset=qoff, block_q=blk, block_k=blk, window=window)
    want = r_attn.chunked_attention(*r_in, **kw)
    got = t_attn.chunked_attention(*t_in, **kw)
    assert got.dtype == t_in[0].dtype and got.shape == (B, H, Sq, 32)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_chunked_attention_matches_the_plain_kernel_version():
    """Without a window, the blocked online softmax is the full-matrix
    softmax (the TPU kernel's oracle), at any q_offset."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 2, 24, 88, 32, seed=5))
    got = t_attn.chunked_attention(q, k, v, q_offset=64, block_q=16, block_k=32)
    want = t_ref.mha_attention(q, k, v, q_offset=64)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_rope_matches_reference_at_qwen3_theta_and_length():
    """theta = 1e6 (qwen3) at positions up to 4112 (a 4096-token prefill and
    16 decodes): the f32 angles and rotations agree to f32 rounding."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 4112, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(4112, dtype=np.int32), (2, 4112)).copy()
    np.testing.assert_allclose(t_attn.rope_frequencies(128, 1e6).numpy(),
                               np.asarray(r_attn.rope_frequencies(128, 1e6)), rtol=1e-6)
    want = r_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos), "rope", 1e6)
    got = t_attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), "rope", 1e6)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-5, atol=1e-5)
    # the decode shape: one position per sequence, [B, 1]
    want1 = r_attn.apply_rope(jnp.asarray(x[:, :, -1:]), jnp.asarray(pos[:, -1:]), "rope", 1e6)
    got1 = t_attn.apply_rope(torch.from_numpy(x[:, :, -1:]), torch.from_numpy(pos[:, -1:]),
                             "rope", 1e6)
    np.testing.assert_allclose(got1.numpy(), _f32(want1), rtol=1e-5, atol=1e-5)
    # bf16 in, bf16 out: f32 rotation, one rounding on each side
    wantb = r_attn.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), "rope", 1e6)
    gotb = t_attn.apply_rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos), "rope", 1e6)
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(gotb), _f32(wantb), rtol=2 ** -7, atol=1e-6)


def test_rope_variants():
    """'none' is the identity; rope2d (chatglm) and mrope (qwen2-vl) are
    ported (held to the reference in tests/test_torch_vlm_audio.py): each
    rotates, keeps the norm of every rotated pair, and needs its position
    streams; an unknown variant is refused."""
    x = torch.randn(1, 2, 5, 8, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)[None]
    assert t_attn.apply_rope(x, pos, "none") is x
    for variant, streams in (("rope2d", 2), ("mrope", 3)):
        got = t_attn.apply_rope(x, (pos[:, None] + 1).expand(1, streams, 5), variant)
        assert got.shape == x.shape and not torch.allclose(got, x)
        torch.testing.assert_close(got.norm(dim=-1), x.norm(dim=-1), rtol=1e-5, atol=1e-6)
        with pytest.raises(ValueError, match=f"{variant} needs"):
            t_attn.apply_rope(x, pos, variant)
    with pytest.raises(ValueError, match="unknown rope variant"):
        t_attn.apply_rope(x, pos, "alibi")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qk_norm_matches_reference(dtype):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 9, 32)).astype(np.float32) * 3.0
    gain = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    r_dt, t_dt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = r_rms_norm(jnp.asarray(x, r_dt), jnp.asarray(gain))
    got = t_rms_norm(torch.from_numpy(x).to(t_dt), torch.from_numpy(gain))
    assert got.dtype == t_dt
    tol = 1e-6 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# dispatch and the CUDA wrapper
# --------------------------------------------------------------------------- #


def test_ops_attention_takes_the_plain_path_on_cpu():
    B, H, Hk, Sq, Sk, D, causal, qoff = ATTN_CASES[2]
    r_in, t_in = _both(_qkv(B, H, Hk, Sq, Sk, D, seed=11))
    plain0, kernel0 = t_ops.plain_launches, t_flash.flash_launches
    got = t_ops.attention(*t_in, q_offset=qoff, causal=causal)
    assert t_ops.plain_launches == plain0 + 1 and t_flash.flash_launches == kernel0
    want = r_ref.mha_attention(*r_in, causal=causal, q_offset=qoff)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=F32_TOL, atol=F32_TOL)


def test_ops_attention_refuses_other_devices():
    t_in = [torch.from_numpy(a).to("meta") for a in _qkv(1, 2, 2, 8, 8, 32, seed=0)]
    with pytest.raises(ValueError, match="no attention for tensors on meta"):
        t_ops.attention(*t_in)


@pytest.mark.parametrize("dtype,Sq,H,Hk,want", [
    (torch.bfloat16, 1, 16, 8, "decode"),  # qwen3-0.6b's decode step
    (torch.float32, 1, 16, 8, "decode"),
    (torch.bfloat16, 2, 16, 8, "decode"),  # 4 query rows a KV head: the most it takes
    (torch.bfloat16, 3, 16, 8, "wgmma"),
    (torch.bfloat16, 1, 32, 8, "decode"),
    (torch.bfloat16, 2, 32, 8, "wgmma"),
    (torch.bfloat16, 4, 4, 4, "decode"),
    (torch.bfloat16, 4096, 16, 8, "wgmma"),  # qwen3-0.6b's prefill
    (torch.float32, 4096, 16, 8, "f32"),
    (torch.float32, 5, 4, 4, "f32"),
])
def test_wrapper_picks_its_kernel_from_the_shapes(dtype, Sq, H, Hk, want):
    assert t_flash.variant(dtype, Sq, H, Hk) == want


@pytest.mark.parametrize("B,Hk,Sq,Sk,qoff,causal,want", [
    (8, 8, 1, 4112, 4096, True, (896, 5)),  # the served decode: 320 CTAs
    (1, 1, 1, 4112, 4096, True, (128, 33)),  # one KV head: a split per tile
    (64, 8, 1, 4112, 4096, True, (4224, 1)),  # enough CTAs without splitting
    (2, 4, 4, 700, 500, True, (128, 4)),
    (2, 4, 3, 300, 0, False, (128, 3)),
    (1, 2, 1, 100, -5, True, (128, 1)),  # no visible key
    (1, 2, 1, 0, 0, True, (128, 1)),  # no key at all
])
def test_decode_splits_cover_the_visible_keys_in_whole_tiles(B, Hk, Sq, Sk, qoff, causal, want):
    split_len, n_splits = t_flash.decode_splits(B, Hk, Sq, Sk, qoff, causal)
    assert (split_len, n_splits) == want
    kend = Sk if not causal else max(0, min(Sk, qoff + Sq))
    assert split_len % t_flash.BLOCK_K == 0
    assert (n_splits - 1) * split_len < max(kend, 1) <= n_splits * split_len  # none wholly past


def test_kernel_wrapper_refuses_cpu_tensors_and_builds_nothing():
    t_in = [torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 8, 32, seed=0)]
    launches0 = t_flash.flash_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_flash.flash_attention(*t_in)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_flash.flash_attention(*(a.double() for a in t_in))
    assert t_flash.flash_launches == launches0
    assert "flash_attention" not in t_flash.load.__globals__["_libs"]  # nothing built or loaded
