"""The port's native checkpoint I/O (pyrecover_tpu_torch/checkpoint/native_io.py
and its own copy of pyrecover_io.cpp) held to the JAX package's engine.

Checksums are exact integers: the port's tree digest of a file, its
streaming checksum folded into the write pass, and either package's
sidecars must agree bit for bit. Sizes run over the chunk's edges with a
small chunk (4 KiB) so every branch of the tree hash is reached cheaply.
"""

import subprocess

import numpy as np
import pytest
import torch

from pyrecover_tpu.checkpoint import native_io as jax_native_io
from pyrecover_tpu.checkpoint import vanilla as jax_vanilla
from pyrecover_tpu_torch.checkpoint import native_io, vanilla
from pyrecover_tpu_torch.checkpoint.vanilla import (
    Leaf,
    _IncrementalChecksum,
    load_ckpt_vanilla,
    precheck_ckpt_vanilla,
    save_ckpt_vanilla,
    verify_checksum,
)
from pyrecover_tpu_torch.utils import xxh

CHUNK = 4096


@pytest.fixture(autouse=True)
def _engines():
    if not (native_io.available() and jax_native_io.available()):
        pytest.fail("g++ is in this container: both native engines must build")


def random_bytes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", [0, 1, CHUNK - 1, CHUNK, 3 * CHUNK + 5])
def test_file_digest_equals_the_jax_engines(tmp_path, n):
    path = tmp_path / "blob"
    path.write_bytes(random_bytes(n, seed=n))
    want = jax_native_io.hash_file(path, chunk=CHUNK)
    assert native_io.hash_file(path, chunk=CHUNK) == want
    assert xxh.tree_hash_file(path, CHUNK) == want  # the pure-Python fallback
    assert native_io.tree_hash(path.read_bytes(), chunk=CHUNK) == want
    assert native_io.xxh64(path.read_bytes()) == jax_native_io.xxh64(path.read_bytes())


@pytest.mark.parametrize("pieces", [[0], [1, 2, 3], [CHUNK - 1, 1, CHUNK + 7, 3 * CHUNK],
                                    [5 * CHUNK], [CHUNK, CHUNK, 13]])
def test_incremental_checksum_equals_hash_file(tmp_path, pieces):
    """Writes of any sizes, folded into the streaming checksum, give the
    digest of the file they make."""
    data = random_bytes(sum(pieces), seed=len(pieces))
    inc, off = _IncrementalChecksum(chunk=CHUNK), 0
    for n in pieces:
        inc.update(np.frombuffer(data, np.uint8)[off:off + n])
        off += n
    path = tmp_path / "blob"
    path.write_bytes(data)
    assert inc.result() == f"xxh64tree:{CHUNK}:{native_io.hash_file(path, chunk=CHUNK):016x}"


def test_write_read_and_pread_round_trip(tmp_path):
    data = random_bytes(10 * CHUNK + 3, seed=1)
    path = tmp_path / "blob"
    digest = native_io.write_file(path, data, chunk=CHUNK)
    assert path.read_bytes() == data
    got, read_digest = native_io.read_file(path, chunk=CHUNK)
    assert got == data and read_digest == digest == jax_native_io.hash_file(path, chunk=CHUNK)
    for offset, n in ((0, 0), (0, 17), (CHUNK - 3, 2 * CHUNK + 9), (len(data) - 5, 5)):
        out = np.empty(n, np.uint8)
        native_io.pread_into(path, offset, out, chunk=CHUNK)
        assert out.tobytes() == data[offset:offset + n]
    with pytest.raises(OSError):  # past the end of the file
        native_io.pread_into(path, len(data) - 2, np.empty(5, np.uint8), chunk=CHUNK)


def _leaves(seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((3, 40, 24)).astype(np.float32))
    return [Leaf(".params['layers']['w']", (3, 40, 24), "float32", list(w)),
            Leaf(".params['b']", (24,), "bfloat16",
                 [torch.from_numpy(rng.standard_normal(24).astype(np.float32)).bfloat16()]),
            Leaf(".step", (), "int32", [np.array(5, np.int32)])]


def test_sidecars_verify_across_packages(tmp_path):
    """A port save writes an ``xxh64tree:`` sidecar in the write pass that the
    JAX package verifies, and a JAX sidecar verifies in the port; a
    flipped byte fails both."""
    path = tmp_path / "ckpt_1.ckpt"
    save_ckpt_vanilla(path, _leaves(0), {"consumed": 1}, verify=True)
    sidecar = path.with_suffix(".ckpt.sha256").read_text()
    assert sidecar.startswith(f"xxh64tree:{16 * 1024 * 1024}:")
    assert jax_vanilla.verify_checksum(path, sidecar)
    assert sidecar == jax_vanilla.compute_checksum(path)
    jax_sidecar = jax_vanilla.compute_checksum(path)
    assert verify_checksum(path, jax_sidecar)
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0x40
    path.write_bytes(bytes(raw))
    assert not verify_checksum(path, jax_sidecar)
    assert not jax_vanilla.verify_checksum(path, sidecar)


def test_native_read_restores_every_leaf(tmp_path):
    """A restore read leaf by leaf through parallel pread gives back every
    part bit for bit."""
    path = tmp_path / "ckpt_1.ckpt"
    src = _leaves(1)
    save_ckpt_vanilla(path, src, {"consumed": 1}, verify=True)
    dst = _leaves(2)
    assert precheck_ckpt_vanilla(path, verify=True, target=dst) == (True, "")
    load_ckpt_vanilla(path, dst, verify=True)
    for a, b in zip(src, dst):
        for x, y in zip(a.parts, b.parts):
            assert np.array_equal(np.asarray(x.float() if isinstance(x, torch.Tensor) else x),
                                  np.asarray(y.float() if isinstance(y, torch.Tensor) else y))


def test_failed_build_falls_back_to_sha256(tmp_path, monkeypatch):
    """No compiler: the library is not available, a save still verifies
    with a ``sha256::`` sidecar, reads go through Python, and an
    ``xxh64tree:`` sidecar still verifies through the pure-Python hash."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_tried", False)
    monkeypatch.setattr(native_io, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", "/nonexistent")
    assert not native_io.available()
    with pytest.raises(FileNotFoundError):
        native_io._build(tmp_path / "build" / "lib.so")  # g++ is not on PATH
    path = tmp_path / "ckpt_1.ckpt"
    src = _leaves(3)
    save_ckpt_vanilla(path, src, {"consumed": 1}, verify=True)
    sidecar = path.with_suffix(".ckpt.sha256").read_text()
    assert sidecar.startswith("sha256::")
    assert jax_vanilla.verify_checksum(path, sidecar)
    dst = _leaves(4)
    load_ckpt_vanilla(path, dst, verify=True)
    assert torch.equal(dst[0].parts[1], src[0].parts[1])
    assert verify_checksum(path, f"xxh64tree:{CHUNK}:{xxh.tree_hash_file(path, CHUNK):016x}")


def test_library_builds_from_the_ports_own_source(tmp_path):
    """The port compiles its own copy of the C++ engine (no file of the JAX
    tree) into its build directory, named by the source's hash."""
    so = native_io._so_path()
    assert native_io._SRC.parent.name == "native"
    assert native_io._SRC.parent.parent.name == "pyrecover_tpu_torch"
    assert so.exists() and so.parent.parts[-2:] == ("build", "pyrecover_tpu_torch")
    out = subprocess.run(["nm", "-D", str(so)], capture_output=True, text=True)
    if out.returncode == 0:
        assert "pr_pread_into" in out.stdout
    assert vanilla.native_io is native_io
