"""A Zstandard frame decoder in Python and numpy (RFC 8878), for the
chunks of vlsa_tpu's orbax checkpoints (`runner/orbax.py`): TensorStore
compresses each zarr chunk and each OCDBT node with zstd, and the card's
machine has no zstd module.

`decompress(data)` decodes every frame of `data` (skippable frames are
skipped): with or without a content size or a checksum (XXH64, verified),
raw, RLE and compressed blocks, Huffman literals (with a tree, or the
previous block's: treeless; one stream or four), FSE sequences in the
predefined, RLE, compressed and repeat modes, the repeat offsets, and a
window of any size (a match may reach back to any byte of its frame).
Dictionaries raise `ValueError`, as does any frame that is corrupt or cut
short.

Where the work has no chain of dependence it is numpy's: the Huffman code
word that starts at every bit of a stream is looked up at once, the walk
from code word to code word takes _JUMP of them a step (pointer doubling),
and a block's matches are resolved by pointer doubling over its output
(each byte points at the byte it copies, until every one points at a
literal or at an earlier block).  Walking the sequence states is a loop of
Python integer operations.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

_MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50  # ... 0x184D2A5F
_MAX_BLOCK = 1 << 17
_JUMP = 32  # code words a step of the Huffman walk

# RFC 8878 §3.1.1.3.2.1.1: code -> (baseline, extra bits)
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

# §3.1.1.3.2.2: the predefined distributions (accuracy log, counts)
_LL_DEFAULT = (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                   2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1])
_ML_DEFAULT = (6, [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                   -1, -1, -1, -1, -1])
_OF_DEFAULT = (5, [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                   -1, -1, -1, -1, -1])
# the largest symbol and accuracy log of each kind (LL, OF, ML)
_MAX_SYMBOL = (35, 31, 52)
_MAX_LOG = (9, 8, 9)


def _fail(what: str):
    raise ValueError(f"zstd: {what}")


class _Backward:
    """A backward bit stream (§4.1): read from the last byte's highest set
    bit (the padding marker, skipped) towards the first byte; the bits past
    the first byte read as zeros.  `pos` is the number of unread bits."""

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            _fail("a bit stream without its end marker")
        self.n = len(buf)
        padded = np.frombuffer(bytes(buf) + bytes(8), np.uint8).astype(np.uint64)
        words = np.zeros(self.n, np.uint64)
        for k in range(8):
            words |= padded[k:k + self.n] << np.uint64(8 * k)
        self.words = words.tolist()  # the 64 bits that start at each byte
        self.pos = 8 * (self.n - 1) + buf[-1].bit_length() - 1

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        self.pos -= nbits
        lo = self.pos
        if lo >= 0:
            return (self.words[lo >> 3] >> (lo & 7)) & ((1 << nbits) - 1)
        top = lo + nbits
        if top <= 0:
            return 0
        return (self.words[0] & ((1 << top) - 1)) << -lo


def _read_fse_table(buf: bytes, at: int, max_symbol: int, max_log: int) -> Tuple[list, int]:
    """An FSE table description (§4.1.1) at `buf[at:]` -> (its decoding
    table, the bytes it took)."""
    chunk = buf[at:at + 512]
    if not chunk:
        _fail("a table description cut short")
    bits = int.from_bytes(chunk, "little")
    avail = 8 * len(chunk)
    acc_log = (bits & 15) + 5
    if acc_log > max_log:
        _fail(f"an accuracy log of {acc_log} (at most {max_log})")
    used = 4
    remaining = (1 << acc_log) + 1
    threshold = 1 << acc_log
    nbits = acc_log + 1
    probs: List[int] = []
    previous0 = False
    while remaining > 1 and len(probs) <= max_symbol:
        if previous0:
            n0 = len(probs)
            while True:
                rep = (bits >> used) & 3
                used += 2
                n0 += rep
                if rep != 3:
                    break
            if n0 > max_symbol + 1:
                _fail("a table description with too many symbols")
            probs.extend([0] * (n0 - len(probs)))
            if len(probs) > max_symbol:
                break
        big = (2 * threshold - 1) - remaining
        low = (bits >> used) & (threshold - 1)
        if low < big:
            count = low
            used += nbits - 1
        else:
            count = (bits >> used) & (2 * threshold - 1)
            if count >= threshold:
                count -= big
            used += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        probs.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
        if used > avail:
            _fail("a table description cut short")
    if remaining != 1 or used > avail:
        _fail("a corrupt table description")
    return _build_fse(acc_log, probs), (used + 7) // 8


def _build_fse(acc_log: int, probs: List[int]) -> list:
    """The decoding table of a distribution (§4.1.1): [(symbol, bits,
    baseline)] by state."""
    size = 1 << acc_log
    symbols = [0] * size
    high = size - 1
    nxt = [0] * len(probs)
    for s, p in enumerate(probs):
        if p == -1:
            symbols[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = p
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            symbols[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        _fail("a distribution that does not fill its table")
    table = []
    for u in range(size):
        s = symbols[u]
        state = nxt[s]
        nxt[s] += 1
        nb = acc_log - (state.bit_length() - 1)
        table.append((s, nb, (state << nb) - size))
    return table


def _rle_table(symbol: int) -> list:
    return [(symbol, 0, 0)]


def _huffman_weights(buf: bytes, at: int) -> Tuple[List[int], int]:
    """A Huffman tree description's weights (§4.2.1) -> (weights of every
    symbol but the last, the bytes it took)."""
    if at >= len(buf):
        _fail("a Huffman tree description cut short")
    head = buf[at]
    if head >= 128:
        count = head - 127
        nbytes = (count + 1) // 2
        raw = buf[at + 1:at + 1 + nbytes]
        if len(raw) < nbytes:
            _fail("a Huffman tree description cut short")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:count], 1 + nbytes
    end = at + 1 + head
    if end > len(buf) or head == 0:
        _fail("a Huffman tree description cut short")
    table, used = _read_fse_table(buf[:end], at + 1, 255, 6)
    bits = _Backward(buf[at + 1 + used:end])
    log = (len(table) - 1).bit_length()
    s1, s2 = bits.read(log), bits.read(log)
    weights: List[int] = []
    while True:
        sym, nb, base = table[s1]
        weights.append(sym)
        s1 = base + bits.read(nb)
        if bits.pos < 0:
            weights.append(table[s2][0])
            break
        sym, nb, base = table[s2]
        weights.append(sym)
        s2 = base + bits.read(nb)
        if bits.pos < 0:
            weights.append(table[s1][0])
            break
        if len(weights) > 255:
            _fail("too many Huffman weights")
    return weights, 1 + head


def _huffman_table(weights: List[int]) -> Tuple[np.ndarray, np.ndarray, int]:
    """Weights (the last symbol's implied) -> (symbol, code length) by the
    code word of the longest length, and that length (§4.2.1.3)."""
    if len(weights) > 255 or any(w > 11 for w in weights):
        _fail("corrupt Huffman weights")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        _fail("Huffman weights that are all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        _fail("Huffman weights whose sum is not completed by a power of two")
    weights = weights + [rest.bit_length()]
    if max_bits > 11:
        _fail("a Huffman code longer than 11 bits")
    size = 1 << max_bits
    sym = np.zeros(size, np.uint8)
    nbits = np.zeros(size, np.int32)
    start = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                sym[start:start + n] = s
                nbits[start:start + n] = max_bits + 1 - w
                start += n
    return sym, nbits, max_bits


def _huffman_stream(buf: bytes, table, count: int) -> np.ndarray:
    """`count` literals of one Huffman stream (a backward bit stream)."""
    sym, nbits, max_bits = table
    if count == 0:
        if buf:
            _fail("a Huffman stream longer than its literals")
        return np.zeros(0, np.uint8)
    if not buf or buf[-1] == 0:
        _fail("a Huffman stream without its end marker")
    start = 8 * (len(buf) - 1) + buf[-1].bit_length() - 1
    # the code word at each bit position p: bits p-1 down to p-max_bits, as the
    # little-endian integer of bits [p-max_bits, p) (zeros before the stream)
    raw = np.frombuffer(bytes(buf) + bytes(3), np.uint8).astype(np.int32)
    words = raw[:-2] | (raw[1:-1] << 8) | (raw[2:] << 16)
    p = np.arange(start + 1, dtype=np.int32)
    low = np.maximum(p - max_bits, 0)
    window = (words[low >> 3] >> (low & 7)) & ((1 << max_bits) - 1)
    head = p[:max_bits]
    window[:max_bits] = (words[0] & ((1 << head) - 1)) << (max_bits - head)
    # the position after each code word, and after _JUMP of them (pointer doubling):
    # a Python walk visits every _JUMP-th code word, numpy fills in the rest
    nxt = np.maximum(p - nbits[window], 0)
    jump = nxt
    for _ in range(_JUMP.bit_length() - 1):
        jump = jump[jump]
    rows = -(-count // _JUMP)
    anchors = [start]
    for _ in range(rows - 1):
        anchors.append(int(jump[anchors[-1]]))
    order = np.empty((rows, _JUMP), np.int32)
    order[:, 0] = anchors
    for j in range(1, _JUMP):
        order[:, j] = nxt[order[:, j - 1]]
    order = order.reshape(-1)[:count]
    if not (order > 0).all():
        _fail("a Huffman stream cut short")
    if nxt[order[-1]] != 0 or order[-1] != nbits[window[order[-1]]]:
        _fail("a Huffman stream that does not end with its literals")
    return sym[window[order]]


class _Frame:
    """What persists from block to block of a frame."""

    def __init__(self):
        self.out = bytearray()
        self.huffman = None
        self.tables = [None, None, None]  # LL, OF, ML
        self.reps = [1, 4, 8]


def _literals(buf: bytes, frame: _Frame) -> Tuple[np.ndarray, int]:
    """The literals section of a compressed block (§3.1.1.3.1) -> (the
    literals, the bytes it took)."""
    b0 = buf[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (buf[1] << 4), 2
        else:
            size, head = (b0 >> 4) + (buf[1] << 4) + (buf[2] << 12), 3
        if len(buf) < head:
            _fail("a literals header cut short")
        if kind == 0:
            if head + size > len(buf):
                _fail("raw literals cut short")
            return np.frombuffer(buf, np.uint8, size, head).copy(), head + size
        if head >= len(buf):
            _fail("RLE literals cut short")
        return np.full(size, buf[head], np.uint8), head + 1
    head = (3, 3, 4, 5)[fmt]
    if len(buf) < head:
        _fail("a literals header cut short")
    h = int.from_bytes(buf[:head], "little")
    width = (10, 10, 14, 18)[fmt]
    size = (h >> 4) & ((1 << width) - 1)
    csize = (h >> (4 + width)) & ((1 << width) - 1)
    streams = 1 if fmt == 0 else 4
    body = buf[head:head + csize]
    if len(body) < csize:
        _fail("compressed literals cut short")
    at = 0
    if kind == 2:
        weights, at = _huffman_weights(body, 0)
        frame.huffman = _huffman_table(weights)
    elif frame.huffman is None:
        _fail("treeless literals with no earlier Huffman table")
    if streams == 1:
        lit = _huffman_stream(body[at:], frame.huffman, size)
    else:
        jump = body[at:at + 6]
        if len(jump) < 6:
            _fail("a jump table cut short")
        s1, s2, s3 = struct.unpack("<3H", jump)
        at += 6
        s4 = len(body) - at - s1 - s2 - s3
        if s4 < 0:
            _fail("a jump table past its literals")
        part = (size + 3) // 4
        counts = (part, part, part, size - 3 * part)
        if counts[3] < 0:
            _fail("four Huffman streams of too few literals")
        lits = []
        for n, count in zip((s1, s2, s3, s4), counts):
            lits.append(_huffman_stream(body[at:at + n], frame.huffman, count))
            at += n
        lit = np.concatenate(lits)
    return lit, head + csize


def _sequence_tables(buf: bytes, at: int, modes: int, frame: _Frame) -> int:
    for kind, shift in ((0, 6), (1, 4), (2, 2)):
        mode = (modes >> shift) & 3
        if mode == 0:
            log, counts = (_LL_DEFAULT, _OF_DEFAULT, _ML_DEFAULT)[kind]
            frame.tables[kind] = _build_fse(log, counts)
        elif mode == 1:
            if at >= len(buf):
                _fail("an RLE symbol cut short")
            if buf[at] > _MAX_SYMBOL[kind]:
                _fail("an RLE symbol out of range")
            frame.tables[kind] = _rle_table(buf[at])
            at += 1
        elif mode == 2:
            frame.tables[kind], used = _read_fse_table(buf, at, _MAX_SYMBOL[kind],
                                                       _MAX_LOG[kind])
            at += used
        elif frame.tables[kind] is None:
            _fail("a repeated table with no earlier one")
    return at


def _sequences(buf: bytes, frame: _Frame) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The sequences section (§3.1.1.3.2) -> literal lengths, match lengths
    and offsets, with the repeat offsets resolved."""
    empty = np.zeros(0, np.int64)
    if not buf:
        _fail("a sequences section cut short")
    b0 = buf[0]
    if b0 == 0:
        if len(buf) != 1:
            _fail("bytes after an empty sequences section")
        return empty, empty, empty
    if b0 < 128:
        count, at = b0, 1
    elif b0 < 255:
        if len(buf) < 2:
            _fail("a sequences header cut short")
        count, at = ((b0 - 128) << 8) + buf[1], 2
    else:
        if len(buf) < 3:
            _fail("a sequences header cut short")
        count, at = buf[1] + (buf[2] << 8) + 0x7F00, 3
    if at >= len(buf):
        _fail("a sequences header cut short")
    modes = buf[at]
    if modes & 3:
        _fail("reserved bits set in the compression modes")
    at = _sequence_tables(buf, at + 1, modes, frame)
    ll_t, of_t, ml_t = frame.tables
    bits = _Backward(buf[at:])
    read = bits.read
    ll_s = read((len(ll_t) - 1).bit_length())
    of_s = read((len(of_t) - 1).bit_length())
    ml_s = read((len(ml_t) - 1).bit_length())
    lls, mls, offs = [0] * count, [0] * count, [0] * count
    r1, r2, r3 = frame.reps
    for i in range(count):
        ll_code, ll_nb, ll_base = ll_t[ll_s]
        of_code, of_nb, of_base = of_t[of_s]
        ml_code, ml_nb, ml_base = ml_t[ml_s]
        if of_code > 31:
            _fail("an offset code out of range")
        value = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if value > 3:
            off = value - 3
            r1, r2, r3 = off, r1, r2
        else:
            idx = value - (ll != 0)  # 0: rep 1, 1: rep 2, 2: rep 3, 3: rep 1 - 1
            if idx == 0:
                off = r1
            elif idx == 1:
                off = r2
                r1, r2 = r2, r1
            elif idx == 2:
                off = r3
                r1, r2, r3 = r3, r1, r2
            else:
                off = r1 - 1
                if off == 0:
                    _fail("a repeat offset of zero")
                r1, r2, r3 = off, r1, r2
        lls[i], mls[i], offs[i] = ll, ml, off
        if i + 1 < count:
            ll_s = ll_base + read(ll_nb)
            ml_s = ml_base + read(ml_nb)
            of_s = of_base + read(of_nb)
    if bits.pos != 0:
        _fail("a sequence bit stream that does not end with its sequences")
    frame.reps = [r1, r2, r3]
    return (np.asarray(lls, np.int64), np.asarray(mls, np.int64), np.asarray(offs, np.int64))


def _execute(lit: np.ndarray, ll: np.ndarray, ml: np.ndarray, off: np.ndarray,
             frame: _Frame) -> np.ndarray:
    """A block's output from its literals and sequences (§3.1.2.5): each
    byte points at itself (a literal) or at the byte it copies, and
    pointer doubling takes every pointer to a literal or past the block's
    start (the frame's earlier output)."""
    n_lit = int(ll.sum())
    if n_lit > len(lit):
        _fail("sequences that take more literals than the block has")
    rest = len(lit) - n_lit
    seg = np.empty(2 * len(ll) + 1, np.int64)
    seg[0:-1:2], seg[1:-1:2], seg[-1] = ll, ml, rest
    shift = np.zeros_like(seg)
    shift[1:-1:2] = off
    total = int(seg.sum())
    pos = np.arange(total, dtype=np.int64)
    ref = pos - np.repeat(shift, seg)
    is_lit = np.repeat(np.arange(len(seg)) % 2 == 0, seg)
    base = np.zeros(total, np.uint8)
    base[is_lit] = lit
    history = len(frame.out)
    if total and int(ref.min()) < -history:
        _fail("an offset past the start of the frame")
    while True:
        inside = ref >= 0
        nxt = ref.copy()
        nxt[inside] = ref[ref[inside]]
        if np.array_equal(nxt, ref):
            break
        ref = nxt
    out = base[np.maximum(ref, 0)]
    early = ref < 0
    if early.any():
        need = int(-ref.min())
        hist = np.frombuffer(bytes(frame.out[history - need:]), np.uint8)
        out[early] = hist[ref[early] + need]
    return out


def _xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the content checksum's hash, §3.1.1)."""
    m = (1 << 64) - 1
    p1, p2, p3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
    p4, p5 = 9650029242287828579, 2870177450012600261

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, lane):
        return rotl((acc + lane * p2) & m, 31) * p1 & m

    n = len(data)
    i = 0
    if n >= 32:
        v1, v2, v3, v4 = (seed + p1 + p2) & m, (seed + p2) & m, seed, (seed - p1) & m
        lanes = np.frombuffer(data, "<u8", (n // 32) * 4).tolist()
        for j in range(0, len(lanes), 4):
            v1 = rnd(v1, lanes[j])
            v2 = rnd(v2, lanes[j + 1])
            v3 = rnd(v3, lanes[j + 2])
            v4 = rnd(v4, lanes[j + 3])
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & m
        for v in (v1, v2, v3, v4):
            h = ((h ^ rnd(0, v)) * p1 + p4) & m
        i = (n // 32) * 32
    else:
        h = (seed + p5) & m
    h = (h + n) & m
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27) * p1 + p4) & m
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * p1 & m), 23) * p2 + p3) & m
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * p5 & m), 11) * p1 & m
        i += 1
    h ^= h >> 33
    h = h * p2 & m
    h ^= h >> 29
    h = h * p3 & m
    h ^= h >> 32
    return h


def _frame(buf: bytes, at: int) -> Tuple[bytes, int]:
    """One zstd frame at `buf[at:]` (after its magic number) -> (its
    content, the offset past it)."""
    if at >= len(buf):
        _fail("a frame header cut short")
    desc = buf[at]
    at += 1
    fcs_flag, single, checksum, dict_flag = desc >> 6, (desc >> 5) & 1, (desc >> 2) & 1, desc & 3
    if desc & 8:
        _fail("the reserved bit of a frame header is set")
    if not single:
        if at >= len(buf):
            _fail("a frame header cut short")
        at += 1  # the window descriptor: every match may reach the frame's start here
    did_size = (0, 1, 2, 4)[dict_flag]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if at + did_size + fcs_size > len(buf):
        _fail("a frame header cut short")
    if int.from_bytes(buf[at:at + did_size], "little"):
        _fail("frames that need a dictionary are not supported")
    at += did_size
    content_size: Optional[int] = None
    if fcs_size:
        content_size = int.from_bytes(buf[at:at + fcs_size], "little")
        content_size += 256 if fcs_size == 2 else 0
        at += fcs_size
    frame = _Frame()
    while True:
        if at + 3 > len(buf):
            _fail("a block header cut short")
        head = int.from_bytes(buf[at:at + 3], "little")
        at += 3
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        if kind == 1:
            if at >= len(buf):
                _fail("an RLE block cut short")
            if size > _MAX_BLOCK:
                _fail("a block larger than 128 KiB")
            frame.out += bytes([buf[at]]) * size
            at += 1
        elif kind == 3:
            _fail("a block of the reserved type")
        else:
            if size > _MAX_BLOCK:
                _fail("a block larger than 128 KiB")
            body = buf[at:at + size]
            if len(body) < size:
                _fail("a block cut short")
            at += size
            if kind == 0:
                frame.out += body
            else:
                if not body:
                    _fail("an empty compressed block")
                lit, used = _literals(body, frame)
                ll, ml, off = _sequences(body[used:], frame)
                frame.out += _execute(lit, ll, ml, off, frame).tobytes()
        if last:
            break
    out = bytes(frame.out)
    if content_size is not None and content_size != len(out):
        _fail(f"a frame of {len(out)} bytes that declares {content_size}")
    if checksum:
        if at + 4 > len(buf):
            _fail("a checksum cut short")
        if int.from_bytes(buf[at:at + 4], "little") != _xxh64(out) & 0xFFFFFFFF:
            _fail("a checksum that does not match the content")
        at += 4
    return out, at


def decompress(data) -> bytes:
    """The content of every frame of `data`, joined (see the module's
    docstring); `ValueError` for anything else."""
    buf = bytes(data)
    parts = []
    at = 0
    if not buf:
        _fail("no frame")
    while at < len(buf):
        if at + 4 > len(buf):
            _fail("a magic number cut short")
        magic = int.from_bytes(buf[at:at + 4], "little")
        at += 4
        if magic == _MAGIC:
            out, at = _frame(buf, at)
            parts.append(out)
        elif magic & 0xFFFFFFF0 == _SKIPPABLE:
            if at + 4 > len(buf):
                _fail("a skippable frame cut short")
            at += 4 + int.from_bytes(buf[at:at + 4], "little")
            if at > len(buf):
                _fail("a skippable frame cut short")
        else:
            _fail(f"not a frame (magic number {magic:#010x})")
    return b"".join(parts)
