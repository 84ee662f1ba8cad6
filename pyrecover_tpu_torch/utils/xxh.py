"""Pure-Python xxh64 + chunked tree hash (the JAX package's ``utils/xxh.py``,
copied).

Lets the port verify ``xxh64tree:`` checksum sidecars, which the JAX
package writes when its native I/O engine is built. The port writes
``sha256::`` sidecars itself. Pure Python hashes a few MB/s, so verifying
a multi-GB checkpoint this way is slow.
"""

MASK = (1 << 64) - 1
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & MASK


def _round(acc, inp):
    acc = (acc + inp * P2) & MASK
    return (_rotl(acc, 31) * P1) & MASK


def _merge(acc, val):
    acc ^= _round(0, val)
    return (acc * P1 + P4) & MASK


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & MASK
        v2 = (seed + P2) & MASK
        v3 = seed & MASK
        v4 = (seed - P1) & MASK
        while i + 32 <= n:
            v1 = _round(v1, int.from_bytes(data[i:i + 8], "little")); i += 8
            v2 = _round(v2, int.from_bytes(data[i:i + 8], "little")); i += 8
            v3 = _round(v3, int.from_bytes(data[i:i + 8], "little")); i += 8
            v4 = _round(v4, int.from_bytes(data[i:i + 8], "little")); i += 8
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & MASK
        h = _merge(h, v1)
        h = _merge(h, v2)
        h = _merge(h, v3)
        h = _merge(h, v4)
    else:
        h = (seed + P5) & MASK
    h = (h + n) & MASK
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * P1 + P4) & MASK
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * P1) & MASK
        h = (_rotl(h, 23) * P2 + P3) & MASK
        i += 4
    while i < n:
        h ^= (data[i] * P5) & MASK
        h = (_rotl(h, 11) * P1) & MASK
        i += 1
    h ^= h >> 33
    h = (h * P2) & MASK
    h ^= h >> 29
    h = (h * P3) & MASK
    h ^= h >> 32
    return h


def tree_hash_bytes(data: bytes, chunk: int) -> int:
    """xxh64 of the concatenated per-chunk xxh64 digests (matches
    pr_tree_hash in the native engine)."""
    n = len(data)
    chunks = max((n + chunk - 1) // chunk, 1)
    digests = b"".join(
        xxh64(data[i * chunk : (i + 1) * chunk]).to_bytes(8, "little")
        for i in range(chunks)
    )
    return xxh64(digests)


def tree_hash_file(path, chunk: int) -> int:
    digests = []
    with open(path, "rb") as f:
        while True:
            piece = f.read(chunk)
            if not piece and digests:
                break
            digests.append(xxh64(piece).to_bytes(8, "little"))
            if len(piece) < chunk:
                break
    return xxh64(b"".join(digests))
