"""The port's plain kernel versions against the reference's Pallas kernels
(interpret mode) on the same numpy inputs. The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.quantize import (dequantize_blockwise_pallas,
                                    quantize_blockwise_pallas)
from repro_torch.kernels import ops, ref

# the reference's ATTN_CASES (tests/test_kernels.py), with its tolerances,
# and a q offset of 0: (B, Sq, Sk, H, KV, D, causal, window, softcap,
# q_offset, dtype, tol)
ATTN_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0, 0.0, 0, "float32", 2e-5),
    (2, 96, 96, 4, 2, 32, True, 0, 0.0, 0, "float32", 2e-5),
    (1, 128, 128, 8, 2, 64, True, 48, 0.0, 0, "float32", 2e-5),
    (1, 64, 64, 2, 1, 128, False, 0, 0.0, 0, "float32", 2e-5),
    (1, 128, 128, 4, 4, 64, True, 0, 20.0, 0, "float32", 2e-5),
    (1, 128, 128, 4, 2, 64, True, 0, 0.0, 0, "bfloat16", 3e-2),
    (2, 80, 80, 4, 4, 48, True, 0, 0.0, 0, "float32", 2e-5),  # ragged seq
]
# head dim 256 (gemma3, recurrentgemma) with MQA (KV = 1) and a window of 8
# at a small S, at the same tolerances
D256_CASES = [
    (1, 40, 40, 4, 1, 256, True, 8, 0.0, 0, "float32", 2e-5),
    (2, 40, 40, 4, 1, 256, True, 8, 0.0, 0, "bfloat16", 3e-2),
]
# features the card's bf16 tensor-core kernel must take, at the reference's
# bf16 tolerance: softcap, a window, tiles ragged at both ends (300 keys are
# 4 tiles of 64 and a part, with a window edge inside tiles), and a q offset
# with Sq < Sk (the last 64 queries of 200 keys)
BF16_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0, 20.0, 0, "bfloat16", 3e-2),
    (1, 128, 128, 8, 2, 64, True, 48, 0.0, 0, "bfloat16", 3e-2),
    (2, 300, 300, 8, 2, 128, True, 100, 0.0, 0, "bfloat16", 3e-2),
    (1, 64, 200, 4, 2, 128, True, 0, 0.0, 136, "bfloat16", 3e-2),
]
# head dim 80 (h2o-danube-1.8b: 2560 / 32) at GQA 4: a window of 64 whose
# edge falls inside 64-key tiles of a ragged S, a q offset with Sq < Sk,
# in f32 and in bf16, at the same tolerances
D80_CASES = [
    (1, 200, 200, 8, 2, 80, True, 64, 0.0, 0, "float32", 2e-5),
    (2, 72, 200, 8, 2, 80, True, 0, 0.0, 128, "float32", 2e-5),
    (1, 200, 200, 8, 2, 80, True, 64, 0.0, 0, "bfloat16", 3e-2),
]
# head dim 192 (deepseek-v3-671b's MLA prefill: q / k 128 + 64, V padded to
# it) with as many kv heads as q heads: causal, a ragged Sk without a mask
# (Sq != Sk), a q offset with Sq < Sk, in f32 and bf16 at the same
# tolerances; the Pallas kernel takes D = 192 in interpret mode
D192_CASES = [
    (2, 128, 128, 4, 4, 192, True, 0, 0.0, 0, "float32", 2e-5),
    (1, 96, 200, 4, 4, 192, False, 0, 0.0, 0, "float32", 2e-5),
    (1, 72, 200, 4, 4, 192, True, 0, 0.0, 128, "float32", 2e-5),
    (2, 128, 128, 4, 4, 192, True, 0, 0.0, 0, "bfloat16", 3e-2),
    (1, 72, 200, 4, 4, 192, True, 0, 0.0, 128, "bfloat16", 3e-2),
]

# the plain versions: the chunked online softmax the CPU path runs (chunk 48
# leaves a ragged last chunk in every case) and the naive oracle
PLAIN = {
    "chunked": lambda q, k, v, **kw: ops.flash_chunked(q, k, v, chunk=48,
                                                       **kw),
    "oracle": ref.flash_attention,
}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return jnp.asarray(a, getattr(jnp, dtype)), t


@pytest.mark.parametrize("plain", sorted(PLAIN))
@pytest.mark.parametrize("case", ATTN_CASES + D256_CASES + BF16_CASES
                         + D80_CASES + D192_CASES)
def test_plain_flash_matches_pallas_kernel(case, plain):
    b, sq, sk, h, kv, d, causal, window, cap, q_offset, dtype, tol = case
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng.normal(size=(b, sq, h, d)).astype(np.float32), dtype)
    kj, kt = _pair(rng.normal(size=(b, sk, kv, d)).astype(np.float32), dtype)
    vj, vt = _pair(rng.normal(size=(b, sk, kv, d)).astype(np.float32), dtype)
    exp = flash_attention_pallas(qj, kj, vj, causal=causal, window=window,
                                 softcap=cap, q_offset=q_offset, block_q=64,
                                 block_k=64, interpret=True)
    out = PLAIN[plain](qt, kt, vt, causal=causal, window=window, softcap=cap,
                       q_offset=q_offset)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", D80_CASES)
def test_plain_flash_at_head_dim_80_matches_reference_oracle(case):
    """The port's chunked flash at head dim 80 against the reference's
    naive oracle ``repro/kernels/ref.py::flash_attention``, which the Pallas
    kernel's own tests hold it to."""
    b, sq, sk, h, kv, d, causal, window, cap, q_offset, dtype, tol = case
    rng = np.random.default_rng(8)
    qj, qt = _pair(rng.normal(size=(b, sq, h, d)).astype(np.float32), dtype)
    kj, kt = _pair(rng.normal(size=(b, sk, kv, d)).astype(np.float32), dtype)
    vj, vt = _pair(rng.normal(size=(b, sk, kv, d)).astype(np.float32), dtype)
    exp = jref.flash_attention(qj, kj, vj, causal=causal, window=window,
                               softcap=cap, q_offset=q_offset)
    out = ops.flash_chunked(qt, kt, vt, causal=causal, window=window,
                            softcap=cap, q_offset=q_offset)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


def test_flash_dispatch_on_cpu_is_the_chunked_plain_version():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 33, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 33, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 33, 2, 16)).astype(np.float32))
    out = ops.flash_attention(q, k, v, causal=True, chunk=16)
    torch.testing.assert_close(out, ops.flash_chunked(q, k, v, chunk=16),
                               rtol=0, atol=0)
    torch.testing.assert_close(out, ref.flash_attention(q, k, v),
                               rtol=2e-5, atol=2e-5)


def _moments(nblocks: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.02, nblocks * 2048).astype(np.float32)
    # an exact-tie block: scale is 1.0, so x / scale lands on .5 and
    # round-half-to-even decides (2.5 -> 2, 3.5 -> 4, -0.5 -> -0)
    x[:2048] = np.resize(np.array([127.0, 2.5, 3.5, -0.5, -126.5, 0.0],
                                  np.float32), 2048)
    return x


@pytest.mark.parametrize("nblocks,seed", [(1, 0), (3, 1), (64, 2)])
def test_quantize_bit_identical_to_pallas_kernel(nblocks, seed):
    x = _moments(nblocks, seed)
    qj, sj = quantize_blockwise_pallas(jnp.asarray(x), interpret=True)
    qr, sr = jref.quantize_blockwise(jnp.asarray(x))
    qt, st = ops.quantize_blockwise(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    # scales are bit-identical to the reference oracle (which the reference
    # serializer runs off the TPU) and to IEEE division in numpy; the Pallas
    # kernel in interpret mode lowers ``max|x| / 127.0`` to a product with
    # the reciprocal and lands one ulp away in a few blocks (2 of 64 here)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sr))
    amax = np.abs(x.reshape(nblocks, 2048)).max(axis=1)
    np.testing.assert_array_equal(st.numpy(),
                                  np.maximum(amax / np.float32(127.0),
                                             np.float32(1e-12)))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2 ** -23,
                               atol=0)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_dequantize_bit_identical_to_pallas_kernel(out_dtype):
    x = _moments(5, 4)
    qj, sj = quantize_blockwise_pallas(jnp.asarray(x), interpret=True)
    exp = dequantize_blockwise_pallas(qj, sj, interpret=True,
                                      out_dtype=getattr(jnp, out_dtype))
    out = ops.dequantize_blockwise(torch.tensor(np.asarray(qj)),
                                   torch.tensor(np.asarray(sj)),
                                   out_dtype=getattr(torch, out_dtype))
    assert out.dtype == getattr(torch, out_dtype)
    if out_dtype == "bfloat16":
        exp = np.asarray(exp).view(np.int16)
        out = out.view(torch.int16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(exp))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bf16_p_flash(q, k, v, *, window, q_offset, lost_tile=False,
                  causal=True):
    """The bf16 flash kernel's arithmetic in plain torch: f32 scores and
    row sum, P rounded to bf16 for P V, the output rounded to bf16.
    ``lost_tile``: rows with a whole window drop their first 64 keys, as a
    kernel that skipped the tile at the window's edge would."""
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    kk = k.float().repeat_interleave(g, 2)
    vv = v.float().repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, kk)
    qpos = torch.arange(sq)[:, None] + q_offset
    kpos = torch.arange(k.shape[1])[None, :]
    keep = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
    if window:
        keep &= kpos > qpos - window
        if lost_tile:
            keep &= ~((qpos >= window) & (kpos < qpos - window + 65))
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)[..., None]
    o = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), vv) / l
    return o.transpose(1, 2).bfloat16()


# llama4's prefill heads (40 over 8 KV, D = 128) at fewer rows: the first
# rows, where few keys leave P's rounding unaveraged, and the last rows of a
# prompt past an 8192-key window (q_offset puts them there), with the window
# and without (NoPE's causal attention)
P_ROUND_CASES = [("first rows", 256, 256, 0, 0),
                 ("window", 64, 8256, 8192, 8192),
                 ("causal", 64, 8256, 0, 8192)]


@pytest.mark.parametrize("name,sq,sk,window,q_offset", P_ROUND_CASES,
                         ids=[c[0] for c in P_ROUND_CASES])
def test_p_rounding_bound_admits_the_kernels_bf16_p(name, sq, sk, window,
                                                     q_offset):
    """chip_smoke.py's bound for the bf16 flash at llama4's prefill shape
    (rtol one bf16 ulp, atol from the rounding of P) holds the kernel's own
    arithmetic, emulated, against the plain version."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(1, sq, 40, 128, generator=gen).bfloat16()
    k = torch.randn(1, sk, 8, 128, generator=gen).bfloat16()
    v = torch.randn(1, sk, 8, 128, generator=gen).bfloat16()
    kw = dict(causal=True, window=window, q_offset=q_offset)
    plain = ops.flash_chunked(q, k, v, **kw)
    atol = smoke._p_rounding_atol(q, k, v, **kw)
    out = _bf16_p_flash(q, k, v, window=window, q_offset=q_offset)
    assert not torch.equal(out, plain)      # P's rounding shows
    smoke._within(name, out, plain, smoke.D256_BF16_TOL, atol)


def test_p_rounding_bound_catches_a_lost_window_tile():
    """The same bound fails most elements of a kernel that drops the 64 keys
    at the edge of an 8192-key window (they move by ~1.6e-3 rms); atol =
    rtol = 8e-3 fails only the far tail of them."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(1, 64, 40, 128, generator=gen).bfloat16()
    k = torch.randn(1, 8256, 8, 128, generator=gen).bfloat16()
    v = torch.randn(1, 8256, 8, 128, generator=gen).bfloat16()
    kw = dict(causal=True, window=8192, q_offset=8192)
    plain = ops.flash_chunked(q, k, v, **kw)
    atol = smoke._p_rounding_atol(q, k, v, **kw)
    out = _bf16_p_flash(q, k, v, window=8192, q_offset=8192, lost_tile=True)
    tol = smoke.D256_BF16_TOL
    diff = (out.float() - plain.float()).abs()
    rel = tol * plain.float().abs()
    assert (diff > atol + rel).float().mean() > 0.5
    assert (diff > tol + rel).float().mean() < 0.01
    with pytest.raises(SystemExit):
        smoke._within("lost tile", out, plain, tol, atol)


# whisper-large-v3's prefill heads (20, MHA, D = 64) at fewer rows: the
# encoder's and the cross-attention's non-causal softmax over 1500 keys
# (outputs near 0.03), and the first rows of the decoder's causal
# self-attention over its 224-token prompt
WHISPER_P_ROUND_CASES = [("non-causal over 1500 keys", 64, 1500, False),
                         ("causal first rows", 224, 224, True)]


@pytest.mark.parametrize("name,sq,sk,causal", WHISPER_P_ROUND_CASES,
                         ids=[c[0] for c in WHISPER_P_ROUND_CASES])
def test_p_rounding_bound_admits_the_kernels_bf16_p_at_whisper_shapes(
        name, sq, sk, causal):
    """The same bound, without a causal mask and with Sq != Sk, holds the
    kernel's emulated arithmetic at head dim 64; rtol one bf16 ulp alone
    (atol 0) would not: a 1500-key softmax's outputs are small."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(8)
    q = torch.randn(1, sq, 20, 64, generator=gen).bfloat16()
    k = torch.randn(1, sk, 20, 64, generator=gen).bfloat16()
    v = torch.randn(1, sk, 20, 64, generator=gen).bfloat16()
    kw = dict(causal=causal, window=0, q_offset=0)
    plain = ops.flash_chunked(q, k, v, **kw)
    atol = smoke._p_rounding_atol(q, k, v, **kw)
    out = _bf16_p_flash(q, k, v, window=0, q_offset=0, causal=causal)
    assert not torch.equal(out, plain)
    smoke._within(name, out, plain, smoke.D256_BF16_TOL, atol)
    with pytest.raises(SystemExit):
        smoke._within(name, out, plain, smoke.D256_BF16_TOL,
                      torch.zeros_like(atol))


# (B, Sq, Sk, H, KV, D, causal, window, softcap, q_offset): causal, a window
# inside the rows, non-causal with Sq = Sk and with Sq != Sk (whisper's
# cross shape, cut), causal and windowed with a q offset (Sq < Sk)
PAIR_CASES = [(2, 100, 100, 3, 1, 64, True, 0, 0.0, 0),
              (1, 100, 100, 2, 1, 64, True, 30, 0.0, 0),
              (2, 150, 150, 3, 3, 64, False, 0, 0.0, 0),
              (2, 22, 150, 3, 3, 64, False, 0, 0.0, 0),
              (1, 40, 150, 2, 1, 64, True, 0, 0.0, 110),
              (1, 40, 150, 2, 1, 64, True, 25, 0.0, 110)]


@pytest.mark.parametrize("case", PAIR_CASES)
def test_attended_pairs_count_the_plain_masks(case):
    """chip_smoke.py's bound counts the (q, k) pairs the plain version's
    masks leave: causal, window, Sk and q_offset honoured."""
    smoke = _chip_smoke()
    b, sq, sk, h, *_, causal, window, _, q_offset = case
    qpos = (torch.arange(sq) + q_offset)[:, None]
    kpos = torch.arange(sk)[None, :]
    n = int(ops._attn_mask(qpos, kpos, causal, window).sum())
    assert smoke._attended_pairs(case + ("bfloat16", 0.0)) == b * h * n
    if not causal and not window:
        assert n == sq * sk
