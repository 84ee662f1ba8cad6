"""Flash attention (causal, GQA-aware, packing-aware) on hand-written Hopper
kernels, with its gradient as a ``torch.autograd.Function``.

The CUDA kernels in ``csrc/`` replace the Pallas kernels of
``pyrecover_tpu/ops/flash_attention.py`` (forward, dq, dk/dv) and compute
what they compute; the sources' notes say how each is laid out on the card
and what bounds it. The dispatch rule: bf16 at head_dim 64 or 128 runs all
three on tensor-core kernels (wgmma fed by TMA,
``csrc/flash_attention_sm90.cuh``); fp32, and bf16 at d 16, 32 and 256,
run the FMA kernels (``csrc/flash_attention.cu``), and a head dim above
256 their head-dim-chunked variant there (a grid axis over output chunks
of 128 columns). They are compiled with
``nvcc`` for ``sm_90a`` at first use, into ``build/pyrecover_tpu_torch/``
beside the package, and rebuilt when a source changes. The library has a
plain C interface bound with ``ctypes``.

Beside each kernel is its plain PyTorch version (``flash_fwd_reference``,
``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``), which computes
the same function from the same inputs. A wrapper runs the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. Each wrapper counts its launches (``FWD_LAUNCHES``, ``DQ_LAUNCHES``,
``DKV_LAUNCHES``, and of those the tensor-core ones, ``FWD_WGMMA_LAUNCHES``,
``DQ_WGMMA_LAUNCHES`` and ``DKV_WGMMA_LAUNCHES``, and the head-dim-chunked
ones, ``FWD_CHUNKED_LAUNCHES``, ``DQ_CHUNKED_LAUNCHES`` and
``DKV_CHUNKED_LAUNCHES``) so a run can show that its path went through the
kernels.

The kernels are built for head dims 16, 32, 64, 128 and 256, and above
256 for any multiple of 128. The plain versions take any head dim, as the
JAX kernel does by lane padding; on the card a wrapper zero-pads q, k, v
(and ``out``, ``dout``) along d up to the next instance (d 80 and 96 run
the d 128 instance, d 129-255 the d 256 one, d 320 the chunked instance at
d 384), keeps the caller's scale (1/sqrt of the true d), launches, and
slices its outputs back. Zero columns add nothing to q.k, to dS.K or to
P^T dO, so the true columns and lse are the function at the true d. No
head dim raises.

Causality is start-aligned (``qpos >= kpos``), as in the JAX flash kernels;
``sdpa_attention`` aligns at the end. The two agree when ``s == sk``.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernels' instances
MAX_HEAD_DIM = SUPPORTED_HEAD_DIMS[-1]
CHUNK = 128  # above MAX_HEAD_DIM: the chunked instances' column chunk

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"  # includes flash_attention_sm90.cuh
PARTS = 8  # SOURCE's FLASH_PART values: each compiled by an nvcc of its own, at once
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pyrecover_tpu_torch"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

FWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
FWD_WGMMA_LAUNCHES = 0
DQ_WGMMA_LAUNCHES = 0
DKV_WGMMA_LAUNCHES = 0
FWD_CHUNKED_LAUNCHES = 0  # head dims above MAX_HEAD_DIM
DQ_CHUNKED_LAUNCHES = 0
DKV_CHUNKED_LAUNCHES = 0

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the last build in this process


def reset_launch_counts():
    global FWD_LAUNCHES, DQ_LAUNCHES, DKV_LAUNCHES
    global FWD_WGMMA_LAUNCHES, DQ_WGMMA_LAUNCHES, DKV_WGMMA_LAUNCHES
    global FWD_CHUNKED_LAUNCHES, DQ_CHUNKED_LAUNCHES, DKV_CHUNKED_LAUNCHES
    FWD_LAUNCHES = DQ_LAUNCHES = DKV_LAUNCHES = 0
    FWD_WGMMA_LAUNCHES = DQ_WGMMA_LAUNCHES = DKV_WGMMA_LAUNCHES = 0
    FWD_CHUNKED_LAUNCHES = DQ_CHUNKED_LAUNCHES = DKV_CHUNKED_LAUNCHES = 0


def launch_counts():
    """Launches of each kernel, and of those each one's on the tensor-core
    instances."""
    return {"fwd": FWD_LAUNCHES, "dq": DQ_LAUNCHES, "dkv": DKV_LAUNCHES,
            "fwd_wgmma": FWD_WGMMA_LAUNCHES, "dq_wgmma": DQ_WGMMA_LAUNCHES,
            "dkv_wgmma": DKV_WGMMA_LAUNCHES}


def chunked_launch_counts():
    """Launches of each kernel's head-dim-chunked instance (d above
    `MAX_HEAD_DIM`); `reset_launch_counts` zeroes these too."""
    return {"fwd": FWD_CHUNKED_LAUNCHES, "dq": DQ_CHUNKED_LAUNCHES,
            "dkv": DKV_CHUNKED_LAUNCHES}


def _nvcc():
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), DEFAULT_NVCC):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found (set $NVCC or put the CUDA toolkit on PATH): the "
        "flash-attention kernels are built from source at first use"
    )


def _library_path():
    """The library's path, named by the hash of every source in ``csrc/``."""
    sha = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        sha.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libflash_attention_{sha.hexdigest()[:16]}.so"


def _build(path):  # faultcheck: tear-ok -- a build cache, named by its sources' hash
    """Compile ``csrc/flash_attention.cu`` into ``path``: one ``nvcc`` a part
    of the source (its ``FLASH_PART`` values, `PARTS`), all started
    together, then one link of their objects (through a temporary file,
    published with one rename); returns nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    objs = [path.with_name(f"{path.stem}.{os.getpid()}.part{k}.o") for k in range(PARTS)]
    try:
        with contextlib.ExitStack() as running:
            procs = [running.enter_context(subprocess.Popen(
                [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DFLASH_PART={k}", "-o",
                 str(obj), str(SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)) for k, obj in enumerate(objs)]
            logs = [proc.communicate()[0] for proc in procs]
        failed = [f"part {k}: nvcc exited {proc.returncode}:\n{log}"
                  for k, (proc, log) in enumerate(zip(procs, logs)) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, path)
    return "".join(logs) + link.stdout + link.stderr


def build_library():
    """Compile ``csrc/flash_attention.cu`` (if the sources' hash has no
    library yet) and load it. Returns the ``ctypes.CDLL``; later calls reuse
    it."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        # concur: disable-next=blocking-under-lock -- the sources' hash
        # names the one-time build this lock guards
        path = _library_path()
        if not path.exists():
            # concur: disable-next=blocking-under-lock -- one-time lazy nvcc
            # build, guarded by exactly this lock to prevent a double
            # compile; it completes before the first launch can
            BUILD_LOG = _build(path)
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pyrecover_flash_fwd.argtypes = [p] * 7 + [i] * 7 + [f, i, p]
        lib.pyrecover_flash_bwd_dq.argtypes = [p] * 9 + [i] * 7 + [f, i, p]
        lib.pyrecover_flash_bwd_dkv.argtypes = [p] * 10 + [i] * 7 + [f, i, p]
        for fn in (lib.pyrecover_flash_fwd, lib.pyrecover_flash_bwd_dq,
                   lib.pyrecover_flash_bwd_dkv):
            fn.restype = i
        lib.pyrecover_flash_route.argtypes = [i, i, i]
        lib.pyrecover_flash_route.restype = i
        lib.pyrecover_cuda_error_string.argtypes = [i]
        lib.pyrecover_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


# ============================ plain versions =============================


def _scores(q, k, seg_q, causal, scale, seg_k=None):
    """fp32 scores (b, hkv, group, s, sk) and the validity mask (or None).
    ``seg_k`` None means the keys' segment ids are ``seg_q``."""
    b, s, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    mask = None
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = qpos >= kpos  # start-aligned, as the JAX flash kernels
    if seg_q is not None:
        seg_k = seg_q if seg_k is None else seg_k
        same = (seg_q[:, :, None] == seg_k[:, None, :])[:, None, None]
        mask = same if mask is None else mask & same
    return sc, mask


def _grouped(x, hkv):
    """(b, s, hq, ...) -> (b, hkv, group, s, ...)."""
    b, s, hq = x.shape[:3]
    return x.reshape(b, s, hkv, hq // hkv, *x.shape[3:]).movedim(1, 3)


def flash_fwd_reference(q, k, v, seg, causal, scale, seg_k=None):
    """Plain forward: ``(out (b, s, hq, d) in q's dtype, lse (b, hq, s) fp32)``."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    sc, mask = _scores(q, k, seg, causal, scale, seg_k)
    if mask is not None:
        sc = sc.masked_fill(~mask, NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0].reshape(b, hq, s).contiguous()
    return out.reshape(b, s, hq, d).to(q.dtype).contiguous(), lse


def _delta(out, dout, hkv):
    """rowsum(dO * O) per q row, (b, hkv, group, s, 1) fp32."""
    return _grouped((dout.float() * out.float()).sum(-1), hkv)[..., None]


def flash_bwd_dq_reference(q, k, v, seg, out, lse, dout, causal, scale, seg_k=None):
    """Plain dq from the saved lse: p = exp(s - lse), ds = p (dP - δ) scale,
    dq = ds k (what the dq kernel computes)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    sc, mask = _scores(q, k, seg, causal, scale, seg_k)
    if mask is not None:
        sc = sc.masked_fill(~mask, NEG_INF)
    p = torch.exp(sc - lse.reshape(b, hkv, hq // hkv, s)[..., None])
    dg = dout.float().reshape(b, s, hkv, hq // hkv, d)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dg, v.float())
    ds = p * (dp - _delta(out, dout, hkv)) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    return dq.reshape(b, s, hq, d).to(q.dtype).contiguous()


def flash_bwd_dkv_reference(q, k, v, seg, out, lse, dout, causal, scale, seg_k=None):
    """Plain dk, dv from the saved lse, summed over each kv head's GQA
    group (what the dk/dv kernel computes); masked p and ds are zeroed."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    sc, mask = _scores(q, k, seg, causal, scale, seg_k)
    p = torch.exp(sc - lse.reshape(b, hkv, hq // hkv, s)[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dg = dout.float().reshape(b, s, hkv, hq // hkv, d)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dg)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dg, v.float())
    ds = p * (dp - _delta(out, dout, hkv)) * scale
    if mask is not None:
        ds = ds.masked_fill(~mask, 0.0)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.float().reshape(b, s, hkv, hq // hkv, d))
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


# =============================== wrappers ================================

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {"fwd": 0, "dq": 1, "dkv": 2}


def padded_head_dim(d):
    """The head dim a head dim of ``d`` runs at on the card: the smallest of
    `SUPPORTED_HEAD_DIMS` at or above it, and above `MAX_HEAD_DIM` the next
    multiple of `CHUNK` (the chunked instances)."""
    for inst in SUPPORTED_HEAD_DIMS:
        if d <= inst:
            return inst
    return -(-int(d) // CHUNK) * CHUNK


_ROUTES = {0: "cuda-fma", 1: "cuda-wgmma", 2: "cuda-fma-chunked"}


def kernel_route(kernel, dtype, head_dim):
    """``"cuda-wgmma"``, ``"cuda-fma"`` or ``"cuda-fma-chunked"``: which
    instance the library's dispatch runs for ``kernel`` ("fwd", "dq" or
    "dkv") at this dtype and head dim, after padding d to
    `padded_head_dim` (builds the library)."""
    code = build_library().pyrecover_flash_route(_KERNELS[kernel], _DTYPE_CODES[dtype],
                                                 padded_head_dim(head_dim))
    return _ROUTES[code]


def _pad_d(dp, *tensors):
    """Each tensor zero-padded along its last dim to ``dp`` (a new
    contiguous tensor; the kernels' TMA maps are built on it), or as it is
    when it already has ``dp``."""
    return [t if t.shape[-1] == dp else torch.nn.functional.pad(t, (0, dp - t.shape[-1]))
            for t in tensors]


def _check(q, k, v, seg, seg_k=None, out=None, lse=None, dout=None):
    """Validate what the kernels take (the keys' segment ids and the
    backward's ``out``, ``lse`` and ``dout`` too); returns (dtype code,
    shape ints)."""
    b, s, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernels take fp32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if k.shape != (b, sk, hkv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"bad q/k/v shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if seg is not None and (seg.dtype != torch.int32 or seg.shape != (b, s)
                            or (seg_k is None and s != sk)):
        raise ValueError("segment_ids must be int32 (b, s) with s == sk")
    if seg_k is not None and (seg is None or seg_k.dtype != torch.int32
                              or seg_k.shape != (b, sk)):
        raise ValueError("key segment ids must be int32 (b, sk), beside the queries'")
    if out is not None:
        for t in (out, dout):
            if t.shape != q.shape or t.dtype != q.dtype:
                raise ValueError("out and dout must have q's shape and dtype")
        if lse.shape != (b, hq, s) or lse.dtype != torch.float32:
            raise ValueError(f"lse must be fp32 of shape {(b, hq, s)}")
    for t in (q, k, v, seg, seg_k, out, lse, dout):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors")
    return _DTYPE_CODES[q.dtype], (b, s, sk, hq, hkv, d)


def _launch(symbol, label, device, *tensors_then_args):
    """Call one C entry point on ``device``'s current stream: tensors go as
    pointers (None as null), the rest as given; raise on a non-zero
    cudaGetLastError."""
    lib = build_library()
    args = [t.data_ptr() if isinstance(t, torch.Tensor) else t for t in tensors_then_args]
    with torch.cuda.device(device):
        code = getattr(lib, symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        msg = lib.pyrecover_cuda_error_string(code).decode()
        raise RuntimeError(f"{label} launch failed: {msg} ({code})")


def flash_fwd(q, k, v, seg, causal, scale, seg_k=None):
    """Forward: ``(out, lse)``. K1 on CUDA tensors, the plain version on CPU.
    ``seg_k`` (b, sk) gives the keys their own segment ids (None: ``seg``)."""
    global FWD_LAUNCHES, FWD_WGMMA_LAUNCHES, FWD_CHUNKED_LAUNCHES
    code, (b, s, sk, hq, hkv, d) = _check(q, k, v, seg, seg_k)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, seg, causal, scale, seg_k)
    dp = padded_head_dim(d)
    q, k, v = _pad_d(dp, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    _launch("pyrecover_flash_fwd", "flash forward", q.device, q, k, v, seg, seg_k, out, lse,
            b, s, sk, hq, hkv, dp, int(causal), float(scale), code)
    route = kernel_route("fwd", q.dtype, dp)
    FWD_LAUNCHES += 1
    FWD_WGMMA_LAUNCHES += route == "cuda-wgmma"
    FWD_CHUNKED_LAUNCHES += route == "cuda-fma-chunked"
    return (out if dp == d else out[..., :d].contiguous()), lse


def flash_bwd_dq(q, k, v, seg, out, lse, dout, causal, scale, seg_k=None):
    """dq. K2 on CUDA tensors, the plain version on CPU."""
    global DQ_LAUNCHES, DQ_WGMMA_LAUNCHES, DQ_CHUNKED_LAUNCHES
    code, (b, s, sk, hq, hkv, d) = _check(q, k, v, seg, seg_k, out, lse, dout)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, seg, out, lse, dout, causal, scale, seg_k)
    dp = padded_head_dim(d)
    q, k, v, out, dout = _pad_d(dp, q, k, v, out, dout)
    dq = torch.empty_like(q)
    _launch("pyrecover_flash_bwd_dq", "flash dq", q.device, q, k, v, seg, seg_k, out, lse, dout,
            dq, b, s, sk, hq, hkv, dp, int(causal), float(scale), code)
    route = kernel_route("dq", q.dtype, dp)
    DQ_LAUNCHES += 1
    DQ_WGMMA_LAUNCHES += route == "cuda-wgmma"
    DQ_CHUNKED_LAUNCHES += route == "cuda-fma-chunked"
    return dq if dp == d else dq[..., :d].contiguous()


def flash_bwd_dkv(q, k, v, seg, out, lse, dout, causal, scale, seg_k=None):
    """(dk, dv). K3 on CUDA tensors, the plain version on CPU."""
    global DKV_LAUNCHES, DKV_WGMMA_LAUNCHES, DKV_CHUNKED_LAUNCHES
    code, (b, s, sk, hq, hkv, d) = _check(q, k, v, seg, seg_k, out, lse, dout)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, seg, out, lse, dout, causal, scale, seg_k)
    dp = padded_head_dim(d)
    q, k, v, out, dout = _pad_d(dp, q, k, v, out, dout)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("pyrecover_flash_bwd_dkv", "flash dk/dv", q.device, q, k, v, seg, seg_k, out, lse,
            dout, dk, dv, b, s, sk, hq, hkv, dp, int(causal), float(scale), code)
    route = kernel_route("dkv", q.dtype, dp)
    DKV_LAUNCHES += 1
    DKV_WGMMA_LAUNCHES += route == "cuda-wgmma"
    DKV_CHUNKED_LAUNCHES += route == "cuda-fma-chunked"
    if dp != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """The JAX package's ``_flash`` custom VJP: saves (q, k, v, seg, out,
    lse) in the forward; the backward runs the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, scale):
        out, lse = flash_fwd(q, k, v, seg, causal, scale)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        args = (q, k, v, seg, out, lse, dout, ctx.causal, ctx.scale)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, scale=None, block_q=None,
                    block_kv=None, segment_ids=None):
    """Drop-in for ``sdpa_attention`` (same shapes), on the flash kernels.

    q (b, s, hq, d), k/v (b, sk, hkv, d) -> (b, s, hq, d) in q's dtype.
    Raises on ``hq % hkv`` and on ``segment_ids`` with ``s != sk``; the
    default scale is 1/sqrt(d). ``block_q``/``block_kv`` keep the JAX
    signature and are validated as there, but the CUDA kernels run their
    own compile-time tiles (``csrc/flash_attention.cu``), so they do not
    change the result.
    """
    b, s, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if scale is None:
        scale = 1.0 / (d**0.5)
    if hq % hkv:
        raise ValueError(f"n_heads={hq} not divisible by n_kv_heads={hkv}")
    for blk in (block_q, block_kv):
        if blk is not None and blk <= 0:
            raise ValueError(f"block sizes must be positive, got {blk}")
    if segment_ids is not None:
        if s != sk:
            raise ValueError("segment_ids requires q_len == kv_len")
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return FlashAttentionFunction.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
        bool(causal), float(scale),
    )
