"""Pure-Python BLAKE3 (hash mode only, full chunk/tree rules).

The reference links the official `blake3` crate for `crypto::blake3`
(fnc/crypto.rs); this environment has no native blake3, so the RFC-draft
construction is implemented directly: 1024-byte chunks of 64-byte blocks
compressed with the BLAKE3 permutation, then a binary merkle tree of
parent compressions. Throughput is irrelevant here — the SQL function
hashes short strings.
"""

from __future__ import annotations

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

_MASK = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(state, a, b, c, d, mx, my):
    state[a] = (state[a] + state[b] + mx) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 7)


def _round(state, m):
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def _compress(cv, block_words, counter, block_len, flags):
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _round(state, m)
        if r < 6:
            m = [m[p] for p in MSG_PERMUTATION]
    return [
        state[i] ^ state[i + 8] if i < 8 else state[i] ^ cv[i - 8]
        for i in range(16)
    ]


def _words(block: bytes):
    return [
        int.from_bytes(block[i:i + 4], "little") for i in range(0, 64, 4)
    ]


def _chunk_cv(chunk: bytes, counter: int) -> list:
    cv = list(IV)
    blocks = [chunk[i:i + 64] for i in range(0, max(len(chunk), 1), 64)]
    for i, blk in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == len(blocks) - 1:
            flags |= CHUNK_END
        padded = blk + b"\x00" * (64 - len(blk))
        cv = _compress(cv, _words(padded), counter, len(blk), flags)[:8]
    return cv


def blake3(data: bytes, out_len: int = 32) -> bytes:
    chunks = [data[i:i + 1024] for i in range(0, max(len(data), 1), 1024)]
    if len(chunks) == 1:
        # single chunk: root-flagged chunk compression
        cv = list(IV)
        blocks = [
            chunks[0][i:i + 64] for i in range(0, max(len(chunks[0]), 1), 64)
        ]
        out_words = None
        for i, blk in enumerate(blocks):
            flags = 0
            if i == 0:
                flags |= CHUNK_START
            if i == len(blocks) - 1:
                flags |= CHUNK_END | ROOT
            padded = blk + b"\x00" * (64 - len(blk))
            out_words = _compress(cv, _words(padded), 0, len(blk), flags)
            cv = out_words[:8]
        words = out_words
    else:
        # merkle tree: combine leaf CVs pairwise (left-full binary tree)
        cvs = [_chunk_cv(c, i) for i, c in enumerate(chunks)]
        while len(cvs) > 2:
            nxt = []
            for i in range(0, len(cvs) - 1, 2):
                block = cvs[i] + cvs[i + 1]
                nxt.append(_compress(list(IV), block, 0, 64, PARENT)[:8])
            if len(cvs) % 2:
                nxt.append(cvs[-1])
            cvs = nxt
        words = _compress(list(IV), cvs[0] + cvs[1], 0, 64, PARENT | ROOT)
    out = b"".join(w.to_bytes(4, "little") for w in words)
    return out[:out_len]


def blake3_hex(data: bytes) -> str:
    return blake3(data).hex()
