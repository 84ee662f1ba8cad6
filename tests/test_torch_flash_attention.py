"""The port's flash attention (pyrecover_tpu_torch.ops.flash_attention) held
to the JAX package's Pallas flash kernels, run in the Pallas interpreter,
and to its sdpa ground truth.

On the CPU the port's wrappers run their plain PyTorch versions, so these
tests pin the arithmetic each CUDA kernel must reproduce: the forward
(out, lse), dq and dk/dv from the saved lse, and the autograd Function that
ties them together. Inputs are made with numpy from a seed and fed to both
packages. Causality is start-aligned in both flash implementations; sdpa
aligns at the end, so it is compared only where the two agree.

Tolerances: fp32 2e-5 forward and 5e-4 gradients (those of
tests/test_flash_attention.py); bf16 3e-2 forward and 1e-1 gradients, one
bf16 rounding step of O(1)-O(5) values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrecover_tpu.ops.attention import sdpa_attention as jax_sdpa
from pyrecover_tpu.ops.flash_attention import _fwd as jax_flash_fwd
from pyrecover_tpu.ops.flash_attention import flash_attention as jax_flash
from pyrecover_tpu_torch.ops import flash_attention as fa
from pyrecover_tpu_torch.ops.attention import sdpa_attention

FP32 = dict(fwd=2e-5, grad=5e-4)
BF16 = dict(fwd=3e-2, grad=1e-1)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    # the Pallas interpreter for the JAX side, read at each call; one torch
    # thread per xdist worker
    monkeypatch.setenv("PYRECOVER_PALLAS_INTERPRET", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_inputs(b, s, hq, hkv, d, n_segments=0, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    dout = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    seg = None
    if n_segments:
        cuts = np.sort(rng.choice(np.arange(1, s), n_segments - 1, replace=False))
        seg = np.stack([np.searchsorted(cuts, np.arange(s), side="right")] * b)
        seg = seg.astype(np.int32)
    return q, k, v, dout, seg


def jx(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x, dtype=x.dtype if x.dtype == np.int32 else dtype)


def th(x, dtype=torch.float32):
    if x is None:
        return None
    t = torch.from_numpy(x)
    return t if x.dtype == np.int32 else t.to(dtype)


CASES = {
    # id: (b, s, sk, hq, hkv, d, causal, n_segments)
    "mha-causal": (1, 64, 64, 2, 2, 32, True, 0),
    "gqa-causal": (2, 64, 64, 4, 2, 32, True, 0),
    "gqa-full": (1, 64, 64, 4, 2, 32, False, 0),
    "ragged-s": (1, 50, 50, 4, 2, 32, True, 0),
    "d16": (1, 64, 64, 4, 1, 16, True, 0),
    "segments": (1, 64, 64, 4, 2, 32, True, 3),
    # s != sk: start-aligned causality, as the JAX flash kernels
    "s-lt-sk-causal": (1, 40, 72, 4, 2, 16, True, 0),
    "s-gt-sk-causal": (1, 72, 40, 4, 2, 16, True, 0),
    "s-gt-sk-full": (1, 72, 40, 4, 2, 16, False, 0),
    # head dims the kernels are not built for: the JAX kernel lane-pads
    # them, the port's card path zero-pads to the d 128 instance
    "d80-segments": (1, 64, 64, 4, 2, 80, True, 3),
    "d96-ragged": (1, 50, 50, 4, 2, 96, True, 0),
    # above 128: d 160 zero-pads to the d 256 instance, which Gemma's head
    # dim runs as it is
    "d160-segments": (1, 48, 48, 4, 2, 160, True, 3),
    "d256-ragged": (1, 40, 40, 4, 2, 256, True, 0),
    # above 256: the card runs the head-dim-chunked instances (d 320
    # zero-padded to 384, d 512 as it is), which the plain versions stand
    # for here
    "d320-segments-gqa": (1, 40, 40, 4, 2, 320, True, 3),
    "d512-ragged-gqa": (1, 36, 36, 4, 1, 512, True, 2),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_forward_matches_jax_flash_and_sdpa(case):
    b, s, sk, hq, hkv, d, causal, nseg = CASES[case]
    q, k, v, _, seg = make_inputs(b, s, hq, hkv, d, nseg, sk=sk)
    scale = 1.0 / d**0.5
    out, lse = fa.flash_fwd_reference(th(q), th(k), th(v), th(seg), causal, scale)
    ref_out, ref_lse = jax_flash_fwd(
        jx(q), jx(k), jx(v), jx(seg), causal=causal, scale=scale,
        block_q=32, block_kv=32,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=FP32["fwd"], atol=FP32["fwd"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               rtol=FP32["fwd"], atol=FP32["fwd"])
    # the public entry (the autograd Function on the CPU path) and sdpa
    port = fa.flash_attention(th(q), th(k), th(v), causal=causal, segment_ids=th(seg))
    np.testing.assert_array_equal(port.numpy(), out.numpy())
    if causal and s != sk:
        return  # sdpa aligns causality at the end
    sd = jax_sdpa(jx(q), jx(k), jx(v), causal=causal, segment_ids=jx(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(sd), rtol=FP32["fwd"], atol=FP32["fwd"])
    port_sd = sdpa_attention(th(q), th(k), th(v), causal=causal, segment_ids=th(seg))
    np.testing.assert_allclose(port_sd.numpy(), np.asarray(sd), rtol=FP32["fwd"], atol=FP32["fwd"])


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_backward_matches_jax_flash_vjp(case):
    """dq and dk/dv references from the saved lse, and the autograd
    Function, against jax.vjp of the JAX flash (interpret mode)."""
    b, s, sk, hq, hkv, d, causal, nseg = CASES[case]
    q, k, v, dout, seg = make_inputs(b, s, hq, hkv, d, nseg, seed=1, sk=sk)
    scale = 1.0 / d**0.5

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=causal, block_q=32, block_kv=32,
                         segment_ids=jx(seg))

    _, vjp = jax.vjp(f, jx(q), jx(k), jx(v))
    want = [np.asarray(g) for g in vjp(jx(dout))]

    tq, tk, tv, tseg, tdo = th(q), th(k), th(v), th(seg), th(dout)
    out, lse = fa.flash_fwd_reference(tq, tk, tv, tseg, causal, scale)
    args = (tq, tk, tv, tseg, out, lse, tdo, causal, scale)
    got = [fa.flash_bwd_dq_reference(*args), *fa.flash_bwd_dkv_reference(*args)]
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, rtol=FP32["grad"], atol=FP32["grad"],
                                   err_msg=f"d{name}")

    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    o = fa.flash_attention(*leaves, causal=causal, segment_ids=tseg)
    auto = torch.autograd.grad(o, leaves, tdo)
    for g, w, name in zip(auto, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, rtol=FP32["grad"], atol=FP32["grad"],
                                   err_msg=f"autograd d{name}")


def test_bf16_forward_and_grads_close():
    b, s, hq, hkv, d = 1, 64, 4, 2, 32
    q, k, v, dout, _ = make_inputs(b, s, hq, hkv, d, seed=2)

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=True, block_q=32, block_kv=32)

    bf = jnp.bfloat16
    ref, vjp = jax.vjp(f, jx(q, bf), jx(k, bf), jx(v, bf))
    want = vjp(jx(dout, bf))
    leaves = [th(x, torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(), np.asarray(ref, np.float32),
                               rtol=BF16["fwd"], atol=BF16["fwd"])
    got = torch.autograd.grad(out, leaves, th(dout, torch.bfloat16))
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=BF16["grad"], atol=BF16["grad"], err_msg=f"d{name}")


def test_contract_errors():
    q, k, v, _, _ = make_inputs(1, 16, 3, 2, 16)
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(th(q), th(k), th(v))
    q, k, v, _, _ = make_inputs(1, 16, 4, 2, 16)
    seg = torch.zeros(1, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="q_len == kv_len"):
        fa.flash_attention(th(q)[:, :8], th(k), th(v), segment_ids=seg[:, :8])
    with pytest.raises(ValueError, match="positive"):
        fa.flash_attention(th(q), th(k), th(v), block_q=0)
    # any head dim runs the plain version on the CPU; on the card a head
    # dim pads to the next kernel instance, above 256 to a multiple of 128
    q24 = torch.randn(1, 16, 4, 24)
    k24 = q24[:, :, :2].contiguous()
    got = fa.flash_fwd(q24, k24, k24, None, True, 0.2)
    want = fa.flash_fwd_reference(q24, k24, k24, None, True, 0.2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert [fa.padded_head_dim(d) for d in (8, 16, 24, 64, 80, 96, 128)] == [
        16, 16, 32, 64, 128, 128, 128]
    assert {fa.padded_head_dim(d) for d in range(129, 257)} == {256}
    assert [fa.padded_head_dim(d) for d in (257, 320, 384, 385, 512, 1000)] == [
        384, 384, 384, 512, 512, 1024]
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fa.flash_fwd(th(q).half(), th(k).half(), th(v).half(), None, True, 0.25)
    out, lse = fa.flash_fwd(th(q), th(k), th(v), None, True, 0.25)
    with pytest.raises(ValueError, match="lse must be fp32"):
        fa.flash_bwd_dq(th(q), th(k), th(v), None, out, lse[:, :, :8], out, True, 0.25)
    with pytest.raises(ValueError, match="q's shape and dtype"):
        fa.flash_bwd_dkv(th(q), th(k), th(v), None, out.double(), lse, out, True, 0.25)
    # the default scale is 1/sqrt(d)
    out = fa.flash_attention(th(q), th(k), th(v))
    ref, _ = fa.flash_fwd_reference(th(q), th(k), th(v), None, True, 0.25)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("d", [8, 24, 80, 96, 160, 320])
def test_zero_padding_to_the_kernel_instance_is_exact(d):
    """What the card's wrappers do at a head dim without a kernel instance:
    zero-pad q, k, v, out and dout along d to `padded_head_dim`, compute at
    the padded d with the true d's scale, slice the outputs back. Here the
    plain versions stand in for the kernels; the padded function equals the
    one at the true d (fp32, 1e-6: only the einsums' summation order over
    the zero columns differs)."""
    b, s, hq, hkv = 1, 48, 4, 2
    q, k, v, dout, seg = (th(x) for x in make_inputs(b, s, hq, hkv, d, 2, seed=4))
    dp, scale = fa.padded_head_dim(d), d**-0.5
    out, lse = fa.flash_fwd_reference(q, k, v, seg, True, scale)
    qp, kp, vp, outp, doutp = fa._pad_d(dp, q, k, v, out, dout)
    assert qp.shape[-1] == dp and qp.is_contiguous()
    out_p, lse_p = fa.flash_fwd_reference(qp, kp, vp, seg, True, scale)
    bwd = (q, k, v, seg, out, lse, dout, True, scale)
    bwd_p = (qp, kp, vp, seg, outp, lse, doutp, True, scale)
    pairs = [(out_p[..., :d], out), (lse_p, lse),
             (fa.flash_bwd_dq_reference(*bwd_p)[..., :d], fa.flash_bwd_dq_reference(*bwd))]
    pairs += [(a[..., :d], w) for a, w in zip(fa.flash_bwd_dkv_reference(*bwd_p),
                                              fa.flash_bwd_dkv_reference(*bwd))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert not out_p[..., d:].any()  # zero columns stay zero


def test_module_imports_and_runs_without_cuda_or_nvcc(monkeypatch):
    """The kernel module imports, and its CPU path runs, with no card and
    no nvcc; nothing is built and no launch is counted until a CUDA tensor
    arrives, and building without nvcc says so."""
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(fa, "DEFAULT_NVCC", "/nonexistent/nvcc")
    fa.reset_launch_counts()
    q, k, v, _, _ = make_inputs(1, 16, 2, 2, 16)
    out = fa.flash_attention(th(q).requires_grad_(), th(k), th(v))
    out.sum().backward()
    assert fa._lib is None
    assert fa.launch_counts() == {"fwd": 0, "dq": 0, "dkv": 0,
                                  "fwd_wgmma": 0, "dq_wgmma": 0, "dkv_wgmma": 0}
    assert fa.chunked_launch_counts() == {"fwd": 0, "dq": 0, "dkv": 0}
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa._nvcc()


def _grads_dropping(q, k, v, dout, out, lse, scale, drop):
    """fp64 dq, dk, dv of causal GQA attention, rounded to q's dtype, with
    the score positions where ``drop`` (hkv, group, s, sk) is True left out:
    what a kernel that skipped those tiles would return."""
    b, s, hq, d = q.shape
    hkv, g = k.shape[2], hq // k.shape[2]
    Q, dO, O = (x.double().reshape(b, s, hkv, g, d) for x in (q, dout, out))
    K, V = k.double(), v.double()
    keep = torch.ones(s, s, dtype=torch.bool).tril() & ~drop
    p = torch.exp(torch.einsum("bqkgd,bskd->bkgqs", Q, K) * scale
                  - lse.double().reshape(b, hkv, g, s)[..., None]).masked_fill(~keep, 0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dO, V)
    delta = (dO * O).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = (p * (dp - delta) * scale).masked_fill(~keep, 0)
    grads = (torch.einsum("bkgqs,bskd->bqkgd", ds, K).reshape(b, s, hq, d),
             torch.einsum("bkgqs,bqkgd->bskd", ds, Q),
             torch.einsum("bkgqs,bqkgd->bskd", p, dO))
    return tuple(x.to(q.dtype) for x in grads)


def _drop(hkv, g, s, where):
    m = torch.zeros(hkv, g, s, s, dtype=torch.bool)
    m[where] = True
    return m


@pytest.mark.parametrize("mutant", [
    "none", "dkv-skips-a-q-tile", "dkv-skips-a-group-member", "dq-skips-a-kv-tile",
])
def test_smoke_check_catches_skipped_tiles(mutant):
    """chip_smoke's kernel check, element by element and by relative norm,
    passes the same math rounded differently (fp64 then bf16) and rejects
    a kernel that leaves one late tile's contribution out."""
    import chip_smoke

    b, s, hq, hkv, d = 1, 256, 4, 2, 32
    q, k, v, dout, _ = make_inputs(b, s, hq, hkv, d, seed=5)
    q, k, v, dout = (th(x, torch.bfloat16) for x in (q, k, v, dout))
    scale = d**-0.5
    out, lse = fa.flash_fwd_reference(q, k, v, None, True, scale)
    args = (q, k, v, None, out, lse, dout, True, scale)
    ref = (fa.flash_bwd_dq_reference(*args), *fa.flash_bwd_dkv_reference(*args))
    # (the outputs the mutant kernel writes, the score positions it drops)
    outputs, where = {
        "none": (("dq", "dk", "dv"), (slice(0, 0),)),
        "dkv-skips-a-q-tile": (("dk", "dv"), (slice(None), slice(None), slice(192, 224),
                                              slice(128, None))),
        "dkv-skips-a-group-member": (("dk", "dv"), (slice(None), 1, slice(None),
                                                    slice(128, None))),
        "dq-skips-a-kv-tile": (("dq",), (slice(None), slice(None), slice(128, None),
                                         slice(64, 96))),
    }[mutant]
    got = _grads_dropping(q, k, v, dout, out, lse, scale, _drop(hkv, hq // hkv, s, where))
    pairs = [(n, a, r, chip_smoke.BF16_TOL)
             for n, a, r in zip(("dq", "dk", "dv"), got, ref) if n in outputs]
    failures = []
    chip_smoke.check_outputs(mutant, pairs, failures)
    assert failures == ([] if mutant == "none" else [f"{mutant} {n}" for n in outputs])


# The card's cases add the tensor-core instances' tile edges (64-row tiles,
# 64-column boxes): bf16 at d 64 and 128, ragged, multi-batch, s != sk both
# ways, non-causal, and llama-8b's attention (GQA group 4).
CARD_CASES = {
    **CASES,
    "b3-ragged-seg-d128": (3, 1000, 1000, 4, 2, 128, True, 3),
    "d64-s129": (1, 129, 129, 4, 2, 64, True, 0),
    "d64-s255": (2, 255, 255, 4, 4, 64, True, 0),
    "d128-full": (2, 300, 300, 4, 2, 128, False, 0),
    "d64-s-lt-sk": (1, 77, 200, 4, 2, 64, True, 0),
    "d64-s-gt-sk": (2, 200, 77, 4, 2, 64, True, 0),
    "d128-s-lt-sk": (1, 100, 170, 4, 2, 128, True, 0),
    "d128-s-gt-sk": (1, 170, 100, 4, 2, 128, True, 0),
    "llama-8b": (1, 2048, 2048, 32, 8, 128, True, 0),
    "d256-seg": (1, 300, 300, 4, 2, 256, True, 3),
    "d160-ragged": (2, 200, 200, 4, 2, 160, True, 0),
    "d320-ragged-seg": (1, 300, 300, 8, 2, 320, True, 3),
    "d512-full": (2, 130, 130, 4, 4, 512, False, 0),
}


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card():
    """On a CUDA card: each kernel against its plain version on the same
    inputs, fp32 and bf16, ragged and segmented, under chip_smoke's
    element-wise and relative-norm limits; bf16 at d 64 and 128 must run
    the forward, dq and dk/dv on the tensor-core instances, and a head dim
    above 256 on the chunked ones."""
    import chip_smoke

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fa.reset_launch_counts()
    for dtype, tol in ((torch.float32, chip_smoke.FP32_TOL), (torch.bfloat16, chip_smoke.BF16_TOL)):
        for b, s, sk, hq, hkv, d, causal, nseg in CARD_CASES.values():
            q, k, v, dout, seg = make_inputs(b, s, hq, hkv, d, nseg, seed=3, sk=sk)
            tq, tk, tv, tdo = (th(x, dtype).cuda() for x in (q, k, v, dout))
            tseg = None if seg is None else th(seg).cuda()
            scale = 1.0 / d**0.5
            out, lse = fa.flash_fwd_reference(tq, tk, tv, tseg, causal, scale)
            got = fa.flash_fwd(tq, tk, tv, tseg, causal, scale)
            args = (tq, tk, tv, tseg, out, lse, tdo, causal, scale)
            dk, dv = fa.flash_bwd_dkv(*args)
            dk_r, dv_r = fa.flash_bwd_dkv_reference(*args)
            pairs = [
                ("out", got[0], out, tol), ("lse", got[1], lse, chip_smoke.LSE_TOL),
                ("dq", fa.flash_bwd_dq(*args), fa.flash_bwd_dq_reference(*args), tol),
                ("dk", dk, dk_r, tol), ("dv", dv, dv_r, tol),
            ]
            torch.cuda.synchronize()
            failures = []
            chip_smoke.check_outputs(f"{dtype} s{s} d{d}", pairs, failures)
            assert failures == []
            tc = dtype == torch.bfloat16 and d in (64, 128)
            want = "cuda-wgmma" if tc else "cuda-fma-chunked" if d > 256 else "cuda-fma"
            for kernel in ("fwd", "dq", "dkv"):
                assert fa.kernel_route(kernel, dtype, d) == want
    wide = 2 * sum(case[5] > 256 for case in CARD_CASES.values())
    assert fa.chunked_launch_counts() == {"fwd": wide, "dq": wide, "dkv": wide}


def _second_products(q, k, v, dout, scale, policy):
    """out, dq, dk and dv of causal GQA attention in fp32, with the operand
    that the kernels build in fp32 (P for out and dv, dS for dq and dk)
    handed to the second product by ``policy``: "bf16" rounds it to bf16 (as FA2/FA3 do),
    "pair" splits it into hi = bf16(x) and lo = bf16(x - hi) and sums the
    two products in fp32 (as the tensor-core kernels do). bf16 x bf16
    products are exact in fp32, so the fp32 einsums stand in for wgmma."""
    def operand(x):
        hi = x.bfloat16().float()
        return [hi] if policy == "bf16" else [hi, (x - hi).bfloat16().float()]

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    sc, mask = fa._scores(q, k, None, True, scale)
    sc = sc.masked_fill(~mask, fa.NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(-1, keepdim=True)
    out = sum(torch.einsum("bkgqs,bskd->bqkgd", x, v.float()) for x in operand(p)) / l.movedim(3, 1)
    lse = m + torch.log(l)
    p = torch.exp(sc - lse).masked_fill(~mask, 0.0)
    dg = dout.float().reshape(b, s, hkv, hq // hkv, d)
    dv = sum(torch.einsum("bkgqs,bqkgd->bskd", x, dg) for x in operand(p))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dg, v.float())
    o_ref, _ = fa.flash_fwd_reference(q, k, v, None, True, scale)
    ds = (p * (dp - fa._delta(o_ref, dout, hkv)) * scale).masked_fill(~mask, 0.0)
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    dq = sum(torch.einsum("bkgqs,bskd->bqkgd", x, k.float()) for x in operand(ds))
    dk = sum(torch.einsum("bkgqs,bqkgd->bskd", x, qg) for x in operand(ds))
    return {"out": out.reshape(b, s, hq, d).to(q.dtype), "dq": dq.reshape(b, s, hq, d).to(q.dtype),
            "dk": dk.to(k.dtype), "dv": dv.to(v.dtype)}


@pytest.mark.parametrize("output", ["out", "dq", "dk", "dv"])
def test_precision_policy_needs_the_hi_lo_pair(output):
    """Why the tensor-core kernels carry P and dS as a bf16 hi/lo pair: at a
    path-like shape (s 1024, d 128, causal, GQA group 2) the pair stays
    inside chip_smoke's bf16 limits against the plain version, and rounding
    P or dS to bf16 alone (the FA2/FA3 policy) does not."""
    import chip_smoke

    b, s, hq, hkv, d = 1, 1024, 2, 1, 128
    q, k, v, dout, _ = make_inputs(b, s, hq, hkv, d, seed=7)
    q, k, v, dout = (th(x, torch.bfloat16) for x in (q, k, v, dout))
    scale = d**-0.5
    out, lse = fa.flash_fwd_reference(q, k, v, None, True, scale)
    bwd = (q, k, v, None, out, lse, dout, True, scale)
    dk, dv = fa.flash_bwd_dkv_reference(*bwd)
    ref = {"out": out, "dq": fa.flash_bwd_dq_reference(*bwd), "dk": dk, "dv": dv}[output]
    failures = []
    for policy in ("pair", "bf16"):
        got = _second_products(q, k, v, dout, scale, policy)[output]
        chip_smoke.check_outputs(policy, [(output, got, ref, chip_smoke.BF16_TOL)], failures)
    assert failures == [f"bf16 {output}"]


def test_ptxas_summary_names_each_instance():
    """chip_smoke's build report: one line per kernel instance, named by
    kernel, dtype and head dim, with its registers and spill bytes."""
    import chip_smoke

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__8e4c_18_flash_attention_cu_f9"
        "1b10dkv_kernelI13__nv_bfloat16Li32EEEvPKT_S4_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN51_GLOBAL__N__8e4c10dkv_kernelI13__nv_bf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__8e4c_f91b9dq_kernelIfLi128EEEvP"
        "KT_S3_' for 'sm_90a'",
        "    16 bytes stack frame, 20 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 16 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_ZN4sm9015dq_wgmma_kernelILi64EEEv14CUtensorMap_"
        "stS1_' for 'sm_90a'",
        "ptxas info    : Used 165 registers, used 1 barriers",
    ])
    assert chip_smoke.ptxas_summary(log) == [
        "dkv_kernel<bf16, 32>: 128 registers, 0 bytes spill stores, 0 bytes spill loads",
        "dq_kernel<fp32, 128>: 128 registers, 20 bytes spill stores, 16 bytes spill loads",
        "dq_wgmma_kernel<bf16, 64>: 165 registers",
    ]
