"""Inspect a checkpoint of any engine (the JAX package's
``tools/inspect_checkpoint.py``): step/epoch metadata, the sampler's
data-order state, the leaves' count, shapes, dtypes, specs and bytes.

Usage::

    python -m pyrecover_tpu_torch.checkpoint.inspect PATH [--leaves] [--manifest] [--chunks]
    python -m pyrecover_tpu_torch.checkpoint.inspect PATH --reshard-plan --devices N \\
        [--mesh data=2,fsdp=2] [--json]
    python -m pyrecover_tpu_torch.checkpoint.inspect --diff-manifests A B [--json]

``--manifest`` prints the checkpoint's schema manifest as JSON, read from
its metadata alone (no tensor data); ``--leaves`` lists the same rows.
A vanilla file is decoded whole, so the inspection doubles as the
integrity read: a file that does not decode gets the corrupt-file
diagnosis (the sidecar checked against the bytes, the intact frames
counted) and exit 1. ``--chunks`` lists a zerostall manifest's chunk
digests with their presence in the store.

``--reshard-plan --devices N`` dry-runs a topology-elastic restore onto an
N-device mesh from the manifest alone (``checkpoint/elastic.py``: each
leaf's source -> target shard grid, keep/split/concat/regrid, the saved
shards a target shard reads, the bytes moved, and the preflight's SC11 /
SC05 findings); the target specs are the partition rules, the mesh pure
data parallelism unless ``--mesh`` sets axis sizes (``data=-1`` takes what
the others leave). Exit 0 when the plan is feasible, 1 when the preflight
rejects it, 2 when the checkpoint or the mesh cannot be read.

``--diff-manifests A B`` diffs two zerostall manifests' per-leaf chunk
digests: the changed and unchanged leaves, the bytes a replica must fetch
and the bytes its loaded copy covers, which is what a hot swap between
them costs (``serving/hotswap/fetch.py::diff_manifest_chunks``); ``--json``
prints that document.
"""

import argparse
import json
import sys
from pathlib import Path


def human(n):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def _manifest_nbytes(entry):
    from pyrecover_tpu_torch.checkpoint.vanilla import _itemsize

    n = _itemsize(entry["dtype"])
    for s in entry["shape"]:
        n *= s
    return n


def _print_manifest_rows(manifest, show_leaves):
    total = sum(_manifest_nbytes(e) for e in manifest["leaves"])
    print(f"leaves: {manifest['num_leaves']} | total {human(total)}")
    if show_leaves:
        for e in manifest["leaves"]:
            spec = f" @ {e['spec']}" if e.get("spec") is not None else ""
            print(f"  {e['path']}: {e['dtype']} {tuple(e['shape'])} "
                  f"{human(_manifest_nbytes(e))}{spec}")


def inspect_vanilla(path, show_leaves):
    from pyrecover_tpu_torch.checkpoint.manifest import manifest_from_ckpt_meta
    from pyrecover_tpu_torch.checkpoint.vanilla import read_ckpt_raw

    try:
        # the whole decode: the inspection is the integrity read too
        meta, _, _ = read_ckpt_raw(path)
    except Exception as e:
        return _diagnose_corrupt_vanilla(Path(path), e)
    print(f"format: vanilla single-file (v{meta['format']})")
    for k in ("step", "epoch"):
        if k in meta:
            print(f"{k}: {meta[k]}")
    if meta.get("sampler"):
        print(f"sampler state: {meta['sampler']}")
    _print_manifest_rows(manifest_from_ckpt_meta(meta), show_leaves)
    return 0


def _diagnose_corrupt_vanilla(path, err):
    """The forensics of a file that does not decode: one read, the sidecar
    checked against those bytes, and the frame walk
    (``checkpoint/vanilla.py::diagnose_ckpt_bytes``). Never raises."""
    print(f"CORRUPT: checkpoint does not fully decode ({type(err).__name__}: {err})")
    try:
        import hashlib

        from pyrecover_tpu_torch.checkpoint import native_io
        from pyrecover_tpu_torch.checkpoint.vanilla import _sidecar, diagnose_ckpt_bytes
        from pyrecover_tpu_torch.utils import xxh

        data = path.read_bytes()
        print(f"file size: {human(len(data))}")
        sidecar = _sidecar(path)
        if sidecar.exists():
            try:
                algo, param, digest = sidecar.read_text().strip().split(":", 2)
                if algo == "xxh64tree":
                    chunk = int(param)
                    actual = (native_io.tree_hash(data, chunk=chunk) if native_io.available()
                              else xxh.tree_hash_bytes(data, chunk))
                    ok = f"{actual:016x}" == digest
                else:
                    ok = hashlib.sha256(data).hexdigest() == digest
                print("checksum vs sidecar: " + (
                    "OK (sidecar matches this content)" if ok
                    else "MISMATCH (file truncated or bit-flipped after save)"))
            except Exception as e:
                print(f"checksum vs sidecar: unreadable ({e})")
        else:
            print("checksum vs sidecar: no sidecar present")
        d = diagnose_ckpt_bytes(data)
        if not d["magic_ok"]:
            print("v2 magic header missing — legacy v1 msgpack or not a pyrecover checkpoint")
            return 1
        if d["meta"] is None:
            print(f"meta header unreadable ({d['meta_error']}); nothing else recoverable")
            return 1
        print(f"meta header intact: step={d['meta'].get('step')} "
              f"leaves={d['meta'].get('num_leaves', len(d['meta'].get('leaves', [])))}")
        print(f"intact leaf frames: {d['intact_leaves']}/"
              f"{d['meta'].get('num_leaves', len(d['meta'].get('leaves', [])))} (container "
              f"breaks at byte {d['break_offset']} of {len(data)})")
        print("the trainer's 'latest' resume falls back past this file automatically; delete "
              "it (and its sidecar) once diagnosed")
    except Exception as e:  # the forensics must never crash as the decode did
        print(f"(forensics incomplete: {type(e).__name__}: {e})")
    return 1


def inspect_zerostall(path, show_leaves, show_chunks):
    """A zerostall manifest's view: step/sampler, the manifest rows, the
    chunk reuse ledger and (``--chunks``) each leaf's chunk digests."""
    from pyrecover_tpu_torch.checkpoint.zerostall import chunkstore

    path = Path(path)
    try:
        doc = chunkstore.read_manifest(path)
    except Exception as e:
        print(f"CORRUPT: manifest does not parse ({type(e).__name__}: {e})")
        print("a torn zerostall save never publishes its manifest — this file was damaged "
              "AFTER commit; the trainer's 'latest' resume falls back past it automatically")
        return 1
    print("format: zerostall manifest + content-addressed chunks")
    for k in ("step", "epoch"):
        if k in doc:
            print(f"{k}: {doc[k]}")
    if doc.get("sampler"):
        print(f"sampler state: {doc['sampler']}")
    _print_manifest_rows(doc["manifest"], show_leaves)
    reuse = doc.get("reuse") or {}
    if reuse:
        print(f"chunks: {reuse.get('chunks_total')} ({reuse.get('chunks_written')} written, "
              f"{reuse.get('chunks_reused')} deduped) | bytes "
              f"{human(reuse.get('bytes_written', 0))} written, "
              f"{human(reuse.get('bytes_reused', 0))} deduped "
              f"@ {human(doc.get('chunk_bytes', 0))} chunk size")
    if show_chunks:
        root = chunkstore.chunks_root(path.parent)
        for entry in doc.get("leaves", []):
            missing = sum(1 for d in entry["chunks"]
                          if not chunkstore.chunk_path(root, d).is_file())
            state = "ok" if not missing else f"{missing} MISSING"
            print(f"  {entry['path']}: {len(entry['chunks'])} chunk(s), {entry['reused']} "
                  f"reused, {state}")
            for d in entry["chunks"]:
                print(f"    {d}")
    return 0


def inspect_sharded(path, show_leaves):
    from pyrecover_tpu_torch.checkpoint.manifest import read_ckpt_manifest
    from pyrecover_tpu_torch.checkpoint.sharded import read_meta

    print("format: sharded (torch.distributed.checkpoint) directory")
    try:
        meta = read_meta(path)
        for k in ("step", "epoch"):
            if k in meta:
                print(f"{k}: {meta[k]}")
        if meta.get("sampler"):
            print(f"sampler state: {meta['sampler']}")
    except Exception as e:
        print(f"warning: meta unreadable: {e}", file=sys.stderr)
    _print_manifest_rows(read_ckpt_manifest(path), show_leaves)
    return 0


def _parse_mesh_arg(mesh_arg, n_devices):
    """``data=2,fsdp=2`` -> every axis's size over ``n_devices``, in the
    mesh's axis order."""
    from pyrecover_tpu_torch.parallel.mesh import MESH_AXES, MeshConfig

    kwargs = {}
    if mesh_arg:
        alias = {"tensor": "tensor", "tp": "tensor", "dp": "data", "data": "data",
                 "fsdp": "fsdp", "sp": "sequence", "sequence": "sequence", "pp": "pipeline",
                 "pipeline": "pipeline", "ep": "expert", "expert": "expert"}
        for part in mesh_arg.split(","):
            k, _, v = part.partition("=")
            key = alias.get(k.strip())
            if key is None or not v:
                raise ValueError(f"bad --mesh entry {part!r}: want axis=size with axis one of "
                                 f"{sorted(set(alias))}")
            kwargs[key] = int(v)
    shape = MeshConfig(**kwargs).shape(n_devices)
    return {a: int(shape.get(a, 1)) for a in MESH_AXES}


def reshard_plan_main(path, devices, mesh_arg, as_json):
    from pyrecover_tpu_torch.checkpoint import elastic
    from pyrecover_tpu_torch.checkpoint.manifest import manifest_from_ckpt_meta
    from pyrecover_tpu_torch.parallel.sharding import spec_for_manifest_path

    try:
        meta = elastic.read_saved_meta(path)
    except Exception as e:
        print(f"ERROR: cannot read checkpoint meta: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    manifest = manifest_from_ckpt_meta(meta)
    try:
        target_mesh = _parse_mesh_arg(mesh_arg, devices)
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    target_topo = {"devices": int(devices), "processes": 1, "mesh": target_mesh}
    # each leaf's target spec: the partition rules, as a restore places it
    specs = {e["path"]: spec_for_manifest_path(e["path"], len(e["shape"]))
             for e in manifest["leaves"]}
    findings, plan = elastic.preflight_elastic(
        manifest, meta.get("topology"), target_topo, sampler_state=meta.get("sampler") or {},
        locus=Path(path).name, target_specs=specs)
    if as_json:
        doc = plan.as_dict()
        doc["findings"] = [{"id": f.rule_id, "rule": f.rule, "severity": f.severity,
                            "message": f.message} for f in findings]
        print(json.dumps(doc, indent=2))
    else:
        elastic.render_plan(plan, sys.stdout)
        for f in findings:
            print(f"  {f.rule_id} [{f.severity}] {f.message}")
    return 0 if not findings else 1


def diff_manifests_main(path_a, path_b, as_json):
    """The chunk-digest diff of two zerostall manifests. Exit 0, or 2 when
    either is not a readable zerostall manifest."""
    from pyrecover_tpu_torch.checkpoint.registry import engine_of
    from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import read_manifest
    from pyrecover_tpu_torch.serving.hotswap.fetch import diff_manifest_chunks

    docs = []
    for p in (path_a, path_b):
        p = Path(p)
        if engine_of(p) != "zerostall":
            print(f"ERROR: {p} is not a zerostall manifest (chunk-digest diffs need the "
                  "content-addressed engine)", file=sys.stderr)
            return 2
        try:
            docs.append(read_manifest(p))
        except Exception as e:
            print(f"ERROR: cannot read {p}: {type(e).__name__}: {e}", file=sys.stderr)
            return 2
    diff = diff_manifest_chunks(docs[0], docs[1])
    if as_json:
        print(json.dumps(diff, indent=2))
        return 0
    print(f"manifest diff: {Path(path_a).name} -> {Path(path_b).name}")
    print(f"leaves: {diff['num_leaves']} total, {diff['changed_leaves']} changed")
    for row in diff["leaves"]:
        state = ("NEW" if row["new_leaf"]
                 else f"{row['chunks_changed']}/{row['chunks_total']} chunks" if row["changed"]
                 else "unchanged")
        print(f"  {row['path']}: {state} | fetch {human(row['fetch_bytes'])}, reuse "
              f"{human(row['reused_bytes'])}")
    total = diff["fetch_bytes"] + diff["reused_bytes"]
    pct = 100.0 * diff["fetch_bytes"] / total if total else 0.0
    print(f"bytes to fetch: {human(diff['fetch_bytes'])} of {human(total)} ({pct:.1f}%) | "
          f"reused in place: {human(diff['reused_bytes'])} | chunks "
          f"{diff['chunks_changed']}/{diff['chunks_total']} changed")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--leaves", action="store_true", help="list every leaf")
    ap.add_argument("--diff-manifests", nargs=2, metavar=("A", "B"), default=None,
                    help="per-leaf changed/unchanged chunk-digest diff and bytes-to-fetch "
                    "between two zerostall manifests (text; --json for the document)")
    ap.add_argument("--chunks", action="store_true",
                    help="zerostall checkpoints: every leaf's chunk digests and presence")
    ap.add_argument("--manifest", action="store_true",
                    help="print the schema manifest JSON (paths/shapes/dtypes/specs); "
                    "metadata read only")
    ap.add_argument("--reshard-plan", action="store_true",
                    help="dry-run a topology-elastic restore onto --devices N from the "
                    "manifest alone: the shard mapping, bytes moved and preflight verdict")
    ap.add_argument("--devices", type=int, default=None,
                    help="target device count for --reshard-plan")
    ap.add_argument("--mesh", type=str, default="",
                    help="target mesh axis sizes for --reshard-plan, e.g. data=2,fsdp=2 "
                    "(default: pure data parallelism)")
    ap.add_argument("--json", action="store_true",
                    help="with --reshard-plan/--diff-manifests: emit JSON")
    args = ap.parse_args(argv)
    if args.diff_manifests:
        return diff_manifests_main(*args.diff_manifests, args.json)
    if args.checkpoint is None:
        ap.error("checkpoint path required (or use --diff-manifests A B)")
    p = Path(args.checkpoint)
    if not p.exists():
        print(f"ERROR: {p} does not exist", file=sys.stderr)
        return 2
    if args.reshard_plan:
        if not args.devices:
            print("ERROR: --reshard-plan requires --devices N", file=sys.stderr)
            return 2
        return reshard_plan_main(p, args.devices, args.mesh, args.json)
    if args.manifest:
        from pyrecover_tpu_torch.checkpoint.manifest import read_ckpt_manifest

        try:
            print(json.dumps(read_ckpt_manifest(p), indent=2))
        except Exception as e:
            print(f"ERROR: cannot read manifest: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
        return 0
    from pyrecover_tpu_torch.checkpoint.registry import engine_of

    engine = engine_of(p)
    if engine == "sharded":
        return inspect_sharded(p, args.leaves)
    if engine == "zerostall":
        return inspect_zerostall(p, args.leaves, args.chunks)
    return inspect_vanilla(p, args.leaves)


def _die_quietly_on_sigpipe():
    """Behave like a unix tool when piped into ``head``. At the script's
    entry only: ``main()`` also runs in-process (tests), where resetting
    the process's SIGPIPE disposition would turn a later write to a closed
    socket into a silent kill."""
    import contextlib
    import signal

    with contextlib.suppress(Exception):
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)


if __name__ == "__main__":
    _die_quietly_on_sigpipe()
    sys.exit(main())
