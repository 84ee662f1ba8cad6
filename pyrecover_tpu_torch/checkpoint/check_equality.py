"""Checkpoint weight-equality verdict (the JAX package's
``tools/check_equality.py``, the reference's ``check_weights_equality.py``):
compare the model weights of two checkpoints of any engine, in any mix
(vanilla ``PYRCKPT2`` files, the port's DCP directories, zerostall
manifests), by key set, then shape, then the largest absolute difference
against ``--tolerance`` (default 1e-7). Exit codes: 0 equal, 1 different,
2 an error.

It is the verdict of the bit-exact-resume benchmark: train straight
through and interrupted + resumed, then compare the final checkpoints.

Usage::

    python -m pyrecover_tpu_torch.checkpoint.check_equality CKPT_A CKPT_B \\
        [--tolerance 1e-7] [--all-state] [--quiet]

Only ``params`` leaves are compared unless ``--all-state`` asks for the
whole training state (optimizer moments, counters, the RNG). A sharded
directory's slices are assembled whole, and every leaf is read on the host
(bf16 as its exact fp32 values).
"""

import argparse
import re
import sys
from pathlib import Path

import numpy as np

from pyrecover_tpu_torch.checkpoint.registry import engine_of


def _norm_key(keystr):
    """A leaf key path as a dotted path usable across engines:
    ``.params['layers']['wq']`` -> ``params.layers.wq``."""
    parts = re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\['([^']+)'\]|\[(\d+)\]", keystr)
    return ".".join(attr or key or idx for attr, key, idx in parts)


def load_vanilla(path):
    from pyrecover_tpu_torch.checkpoint.vanilla import read_ckpt_raw

    _, paths, leaves = read_ckpt_raw(path)
    return {_norm_key(p): v for p, v in zip(paths, leaves)}


def load_zerostall(path):
    from pyrecover_tpu_torch.checkpoint.vanilla import host_array
    from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import (
        ChunkStore,
        assemble_leaf,
        read_manifest,
    )

    path = Path(path)
    doc = read_manifest(path)
    store = ChunkStore(path.parent)
    return {_norm_key(e["path"]): host_array(assemble_leaf(store, e), e["dtype"],
                                             tuple(e["shape"]))
            for e in doc["leaves"]}


def load_sharded(path):
    import torch

    from pyrecover_tpu_torch.checkpoint.sharded import _read_back, read_meta
    from pyrecover_tpu_torch.checkpoint.vanilla import _TORCH_DTYPES, Leaf

    meta = read_meta(path)
    host = meta.get("host_leaves", {})
    out, leaves = {}, []
    for p, lm in zip(meta["paths"], meta["leaves"]):
        if p in host:
            out[_norm_key(p)] = np.asarray(host[p]["value"], dtype=host[p]["dtype"])
            continue
        shape, dtype = tuple(lm["shape"]), _TORCH_DTYPES[lm["dtype"]]
        # a stacked leaf is saved a layer a part
        parts = ([torch.empty(shape[1:], dtype=dtype) for _ in range(shape[0])]
                 if "['layers']" in p else [torch.empty(shape, dtype=dtype)])
        leaves.append(Leaf(p, shape, lm["dtype"], parts))
    for p, parts in _read_back(path, leaves).items():
        whole = torch.stack(parts) if "['layers']" in p else parts[0]
        out[_norm_key(p)] = (whole.float() if whole.dtype == torch.bfloat16 else whole).numpy()
    return out


def load_checkpoint(path):
    """``{dotted leaf path: numpy array}`` of the checkpoint at ``path``."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(p)
    return {"vanilla": load_vanilla, "zerostall": load_zerostall,
            "sharded": load_sharded}[engine_of(p)](p)


def compare(a, b, tolerance, params_only=True, verbose=True):
    """True when ``a`` and ``b`` are equal within ``tolerance``: key set,
    then shape, then the largest absolute difference a leaf."""
    if params_only:
        a = {k: v for k, v in a.items() if k.startswith("params.")}
        b = {k: v for k, v in b.items() if k.startswith("params.")}
    ok = True
    only_a, only_b = set(a) - set(b), set(b) - set(a)
    if only_a or only_b:
        ok = False
        if verbose:
            for k in sorted(only_a):
                print(f"KEY only in A: {k}")
            for k in sorted(only_b):
                print(f"KEY only in B: {k}")
    worst = (0.0, None)
    for k in sorted(set(a) & set(b)):
        va, vb = a[k], b[k]
        if va.shape != vb.shape:
            ok = False
            if verbose:
                print(f"SHAPE mismatch {k}: {va.shape} vs {vb.shape}")
            continue
        diff = float(np.max(np.abs(va.astype(np.float64) - vb.astype(np.float64)))) \
            if va.size else 0.0
        if diff > worst[0]:
            worst = (diff, k)
        if diff > tolerance:
            ok = False
            if verbose:
                print(f"VALUE mismatch {k}: max abs diff {diff:.3e}")
    if verbose:
        if worst[1] is not None:
            print(f"Largest diff: {worst[0]:.3e} at {worst[1]}")
        print("EQUAL within tolerance" if ok else "DIFFERENT")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint_a")
    ap.add_argument("checkpoint_b")
    ap.add_argument("--tolerance", type=float, default=1e-7)
    ap.add_argument("--all-state", action="store_true",
                    help="Compare the full training state, not just params")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    try:
        a = load_checkpoint(args.checkpoint_a)
        b = load_checkpoint(args.checkpoint_b)
        equal = compare(a, b, args.tolerance, params_only=not args.all_state,
                        verbose=not args.quiet)
    except Exception as e:  # exit 2: an error
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
