"""A Zstandard decoder (RFC 8878) in numpy and the standard library.

The JAX package's orbax checkpoints compress every OCDBT node and every zarr
chunk with zstd; the card's machine has no zstd library, so the port reads
them with this decoder. It decodes every frame the format allows but those
that need a dictionary:

- frames with or without a content size, single-segment or windowed,
  concatenated; skippable frames are skipped;
- raw, RLE and compressed blocks;
- literals raw, RLE, or Huffman-coded in 1 or 4 streams, with the tree's
  weights stored directly or FSE-coded, and treeless literals that reuse the
  frame's previous tree;
- sequences with predefined, RLE, FSE-coded and repeated tables (carried
  from block to block), the three repeat offsets with the literal-length-0
  rule, and matches back into earlier blocks of the frame;
- the XXH64 content checksum, checked when the frame header sets it.

:func:`encode` writes the frames the port's orbax checkpoints hold: the
content in raw (stored) blocks, with its size in the header and no checksum.
Any decoder reads them; full-entropy float32 weights would not compress by
much anyway.

A frame that names a dictionary raises
:class:`~hypelcnn_tpu_torch.compat.FormatNotRead`; any corruption the format
lets a decoder see raises :class:`ZstdError`.

Huffman literals (most of a compressed weight file) are decoded without a
per-symbol Python loop: the code at every bit position of a stream is looked
up at once in the ``2**max_bits`` table, each position's successor is
``position - code length``, and the chain of positions the decoder visits is
unrolled by pointer doubling. Sequences are decoded in a Python loop, each
from one slice of the bitstream; a block's literal and match bytes are then
placed with numpy, every match byte resolved to its source by pointer
jumping, which gives what a copy in order gives, overlaps included.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hypelcnn_tpu_torch.compat import FormatNotRead

ZSTD_MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC_MASK = 0xFFFFFFF0
SKIPPABLE_MAGIC = 0x184D2A50
MAX_BLOCK_SIZE = 128 * 1024


class ZstdError(ValueError):
    """A frame this decoder refuses or finds corrupt."""


# ------------------------------------------------------------ bitstreams ----

class _BackwardBits:
    """The backward bitstream of RFC 8878 section 4.1: read from the end,
    the highest set bit of the last byte is padding, bits below the start
    read as zeros."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bitstream ends without its padding bit")
        self.data = data
        self.pos = (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        pos = self.pos - n
        self.pos = pos
        if pos < 0:
            available = n + pos
            if available <= 0:
                return 0
            low = int.from_bytes(self.data[:(available + 7) >> 3], "little")
            return (low & ((1 << available) - 1)) << -pos
        lo = pos >> 3
        hi = (pos + n + 7) >> 3
        return (int.from_bytes(self.data[lo:hi], "little") >> (pos & 7)) & ((1 << n) - 1)


def _read_varsize_le(data: bytes, offset: int, size: int) -> int:
    return int.from_bytes(data[offset:offset + size], "little")


# ------------------------------------------------------------------- FSE ----

def _read_fse_counts(data: bytes, offset: int, max_symbol: int, max_log: int
                     ) -> Tuple[List[int], int, int]:
    """The normalized counts of an FSE table description at ``data[offset:]``
    (section 4.1.1): ``(counts, accuracy_log, bytes_used)``."""
    bits = int.from_bytes(data[offset:offset + 512], "little")
    available = 8 * min(512, len(data) - offset)
    accuracy_log = (bits & 0xF) + 5
    if accuracy_log > max_log:
        raise ZstdError(f"FSE accuracy log {accuracy_log} above {max_log}")
    used = 4
    remaining = (1 << accuracy_log) + 1
    threshold = 1 << accuracy_log
    nbits = accuracy_log + 1
    counts: List[int] = []
    previous_zero = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous_zero:
            while True:
                repeat = (bits >> used) & 3
                used += 2
                counts.extend([0] * repeat)
                if repeat != 3:
                    break
            if len(counts) > max_symbol:
                break
        largest = (2 * threshold - 1) - remaining
        low = (bits >> used) & (threshold - 1)
        if low < largest:
            count = low
            used += nbits - 1
        else:
            count = (bits >> used) & (2 * threshold - 1)
            if count >= threshold:
                count -= largest
            used += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        previous_zero = count == 0
        if remaining < 1:
            raise ZstdError("corrupt FSE table description")
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1 or used > available:
        raise ZstdError("corrupt FSE table description")
    return counts, accuracy_log, (used + 7) >> 3


class _FseTable:
    """A decoding table: per state its symbol, bit count and baseline."""

    __slots__ = ("symbol", "nbits", "base", "log", "rows")

    def __init__(self, counts: Sequence[int], accuracy_log: int):
        self.rows = None
        size = 1 << accuracy_log
        symbol = [0] * size
        high = size - 1
        next_state = [0] * len(counts)
        for s, count in enumerate(counts):
            if count == -1:
                symbol[high] = s
                high -= 1
                next_state[s] = 1
            else:
                next_state[s] = count
        step = (size >> 1) + (size >> 3) + 3
        mask = size - 1
        position = 0
        for s, count in enumerate(counts):
            for _ in range(max(count, 0)):
                symbol[position] = s
                position = (position + step) & mask
                while position > high:
                    position = (position + step) & mask
        if position != 0:
            raise ZstdError("corrupt FSE distribution")
        nbits = [0] * size
        base = [0] * size
        for state in range(size):
            s = symbol[state]
            following = next_state[s]
            next_state[s] += 1
            nbits[state] = accuracy_log - (following.bit_length() - 1)
            base[state] = (following << nbits[state]) - size
        self.symbol, self.nbits, self.base, self.log = symbol, nbits, base, accuracy_log

    @classmethod
    def rle(cls, symbol: int) -> "_FseTable":
        table = cls.__new__(cls)
        table.symbol, table.nbits, table.base, table.log = [symbol], [0], [0], 0
        table.rows = None
        return table

    def code_rows(self, baseline: Sequence[int], extra: Sequence[int]) -> list:
        """Per state: its code's baseline and extra bits, its bit count and
        the baseline of the next state."""
        if self.rows is None:
            self.rows = [(baseline[s], extra[s], nb, base)
                         for s, nb, base in zip(self.symbol, self.nbits, self.base)]
        return self.rows


# ------------------------------------------------------- Huffman literals ----

def _fse_weights(data: bytes) -> List[int]:
    """Huffman weights coded with FSE (section 4.2.1.2): two interleaved
    states over one backward stream, accuracy log at most 6."""
    counts, log, used = _read_fse_counts(data, 0, 255, 6)
    table = _FseTable(counts, log)
    bits = _BackwardBits(data[used:])
    state1, state2 = bits.read(log), bits.read(log)
    weights: List[int] = []
    sym, nb, base = table.symbol, table.nbits, table.base
    while True:
        weights.append(sym[state1])
        state1 = base[state1] + bits.read(nb[state1])
        if bits.pos < 0:
            weights.append(sym[state2])
            break
        weights.append(sym[state2])
        state2 = base[state2] + bits.read(nb[state2])
        if bits.pos < 0:
            weights.append(sym[state1])
            break
        if len(weights) > 255:
            raise ZstdError("corrupt Huffman weights")
    return weights


class _HuffmanTable:
    """The ``2**max_bits`` lookup table of a Huffman tree: symbol and code
    length by the next ``max_bits`` bits of a stream."""

    __slots__ = ("symbol", "length", "max_bits")

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ZstdError("Huffman tree with no symbol")
        max_bits = total.bit_length()
        rest = (1 << max_bits) - total
        if rest & (rest - 1):
            raise ZstdError("Huffman weights do not complete a tree")
        weights = weights + [rest.bit_length()]  # the last weight is implied
        if max_bits > 11 or len(weights) > 256:
            raise ZstdError("corrupt Huffman tree")
        order = sorted((w, s) for s, w in enumerate(weights) if w)
        symbol = np.empty(1 << max_bits, dtype=np.uint8)
        length = np.empty(1 << max_bits, dtype=np.int32)
        start = 0
        for w, s in order:
            span = 1 << (w - 1)
            symbol[start:start + span] = s
            length[start:start + span] = max_bits + 1 - w
            start += span
        self.symbol, self.length, self.max_bits = symbol, length, max_bits

    @classmethod
    def read(cls, data: bytes, offset: int) -> Tuple["_HuffmanTable", int]:
        """The tree description at ``data[offset:]``: ``(table, bytes_used)``."""
        header = data[offset]
        if header < 128:
            weights = _fse_weights(data[offset + 1:offset + 1 + header])
            return cls(weights), 1 + header
        count = header - 127
        packed = data[offset + 1:offset + 1 + (count + 1) // 2]
        weights = []
        for byte in packed:
            weights.extend((byte >> 4, byte & 0xF))
        return cls(weights[:count]), 1 + (count + 1) // 2

    def decode_stream(self, stream: bytes, count: int) -> bytes:
        """``count`` symbols of one backward stream."""
        if count == 0:
            return b""
        if not stream or stream[-1] == 0:
            raise ZstdError("Huffman stream ends without its padding bit")
        width = self.max_bits
        start = (len(stream) - 1) * 8 + stream[-1].bit_length() - 1
        # the window at bit position p (bits p - width .. p - 1, the higher
        # first, zeros below the stream) indexes the table; two zero bytes
        # in front of the stream hold the bits below it
        raw = np.frombuffer(b"\0\0" + stream + b"\0\0", dtype=np.uint8).astype(np.int32)
        words = raw[:-2] | raw[1:-1] << 8 | raw[2:] << 16
        low = np.arange(16 - width, 16 - width + start + 1, dtype=np.int32)
        window = (words[low >> 3] >> (low & 7)) & ((1 << width) - 1)
        step = self.length[window]
        jump = np.maximum(np.arange(start + 1, dtype=np.int32) - step, 0)
        # every _STRIDE-th position of the chain by a loop over a jump of
        # _STRIDE symbols, then the positions between them side by side
        far = jump
        for _ in range(_STRIDE.bit_length() - 1):
            far = far[far]
        rows = (count + _STRIDE - 1) // _STRIDE
        chain = np.empty((_STRIDE, rows), dtype=np.int32)
        position = start
        anchors = chain[0]
        for row in range(rows):
            anchors[row] = position
            position = far[position]
        for column in range(1, _STRIDE):
            chain[column] = jump[chain[column - 1]]
        chain = chain.T.reshape(-1)[:count]
        ends = chain - step[chain]
        if ends[-1] != 0 or (count > 1 and ends[:-1].min() <= 0):
            raise ZstdError("Huffman stream not consumed exactly")
        return self.symbol[window[chain]].tobytes()


_STRIDE = 32  # a power of two

# ------------------------------------------------------------- sequences ----

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
                              1024, 2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = [n + 3 for n in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131,
                                         259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
                                         65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_LL_DEFAULT = ([4, 3] + [2] * 11 + [1] * 3 + [2] * 9 + [3, 2] + [1] * 5 + [-1] * 4, 6)
_ML_DEFAULT = ([1, 4, 3] + [2] * 6 + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1] * 6 + [2] * 3 + [1] * 15 + [-1] * 5, 5)
# (default distribution, max symbol, max accuracy log) by kind
_KINDS = {"literal lengths": (_LL_DEFAULT, 35, 9), "offsets": (_OF_DEFAULT, 31, 8),
          "match lengths": (_ML_DEFAULT, 52, 9)}


class _FrameState:
    """What a frame carries from block to block."""

    def __init__(self):
        self.huffman: Optional[_HuffmanTable] = None
        self.tables = {kind: None for kind in _KINDS}
        self.repeats = [1, 4, 8]
        self.defaults = {kind: _FseTable(*_KINDS[kind][0]) for kind in _KINDS}


def _sequence_table(state: _FrameState, kind: str, mode: int, data: bytes, offset: int
                    ) -> int:
    """Set ``kind``'s table from its compression mode; returns the bytes used."""
    _, max_symbol, max_log = _KINDS[kind]
    if mode == 0:
        state.tables[kind] = state.defaults[kind]
        return 0
    if mode == 1:
        if data[offset] > max_symbol:
            raise ZstdError(f"RLE {kind} symbol {data[offset]} out of range")
        state.tables[kind] = _FseTable.rle(data[offset])
        return 1
    if mode == 2:
        counts, log, used = _read_fse_counts(data, offset, max_symbol, max_log)
        state.tables[kind] = _FseTable(counts, log)
        return used
    if state.tables[kind] is None:
        raise ZstdError(f"repeated {kind} table with none before it")
    return 0


_OF_BASE = [1 << code for code in range(32)]
_OF_BITS = list(range(32))
_MASK = [(1 << n) - 1 for n in range(64)]


def _decode_sequences(state: _FrameState, data: bytes, count: int
                      ) -> Tuple[List[int], List[int], List[int]]:
    """``count`` sequences from ``data`` (the block's rest) as literal
    lengths, match distances (the repeat offsets resolved, ``state``'s
    updated) and match lengths. A sequence's bits are read at once: its
    three states fix how many there are."""
    ll_t, of_t, ml_t = (state.tables[k] for k in _KINDS)
    ll_rows = ll_t.code_rows(_LL_BASE, _LL_BITS)
    of_rows = of_t.code_rows(_OF_BASE, _OF_BITS)
    ml_rows = ml_t.code_rows(_ML_BASE, _ML_BITS)
    bits = _BackwardBits(data)
    ll_state, of_state, ml_state = bits.read(ll_t.log), bits.read(of_t.log), bits.read(ml_t.log)
    pos = bits.pos
    from_bytes, mask = int.from_bytes, _MASK
    rep1, rep2, rep3 = state.repeats
    lengths, distances, matches = [0] * count, [0] * count, [0] * count
    last = count - 1
    for i in range(count):
        ll_base, ll_extra, ll_nb, ll_next = ll_rows[ll_state]
        of_base, of_extra, of_nb, of_next = of_rows[of_state]
        ml_base, ml_extra, ml_nb, ml_next = ml_rows[ml_state]
        total = of_extra + ml_extra + ll_extra
        if i != last:
            total += ll_nb + ml_nb + of_nb
        value = 0
        if total:
            pos -= total
            if pos < 0:
                raise ZstdError("sequence bitstream overread")
            value = from_bytes(data[pos >> 3:(pos + total + 7) >> 3], "little") >> (pos & 7)
        # read order: offset, match and literal extra bits, then the
        # literal, match and offset states; the first read is the highest
        if i != last:
            of_state = of_next + (value & mask[of_nb])
            value >>= of_nb
            ml_state = ml_next + (value & mask[ml_nb])
            value >>= ml_nb
            ll_state = ll_next + (value & mask[ll_nb])
            value >>= ll_nb
        literal_length = ll_base + (value & mask[ll_extra])
        value >>= ll_extra
        matches[i] = ml_base + (value & mask[ml_extra])
        offset_value = of_base + ((value >> ml_extra) & mask[of_extra])
        lengths[i] = literal_length
        if offset_value > 3:
            rep1, rep2, rep3 = offset_value - 3, rep1, rep2
        else:
            index = offset_value - (literal_length != 0)  # 1..3, one more after no literals
            if index == 1:
                rep1, rep2 = rep2, rep1
            elif index == 2:
                rep1, rep2, rep3 = rep3, rep1, rep2
            elif index == 3:
                rep1, rep2, rep3 = rep1 - 1, rep1, rep2
        distances[i] = rep1
    if pos != 0:
        raise ZstdError("sequence bitstream not consumed exactly")
    state.repeats = [rep1, rep2, rep3]
    return lengths, distances, matches


def _ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The concatenated ``arange(start, start + length)`` of each pair."""
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    first = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return np.repeat(starts - first, lengths) + np.arange(total)


def _execute(literals: bytes, lengths, distances, matches, out: bytearray) -> None:
    """Append a block's sequences to ``out``: each copies its literals, then
    its match, byte ``p`` of which is byte ``p - distance`` of the output.
    Every byte's source is known at once; a match byte whose source is
    another match byte takes that byte's source (pointer jumping, so a
    chain of ``n`` copies resolves in ``log2 n`` rounds), which gives what a
    copy in order gives, overlaps included."""
    ll = np.asarray(lengths, dtype=np.int64)
    ml = np.asarray(matches, dtype=np.int64)
    distance = np.asarray(distances, dtype=np.int64)
    literal_count = int(ll.sum())
    if literal_count > len(literals):
        raise ZstdError("sequences use more literals than the block holds")
    base = len(out)
    spans = ll + ml
    starts = np.concatenate([[0], np.cumsum(spans)[:-1]])
    size = int(spans.sum()) + len(literals) - literal_count
    match_starts = starts + ll
    if np.any(distance <= 0) or np.any(distance > base + match_starts):
        raise ZstdError("match offset before the frame's start")
    values = np.empty(size, dtype=np.uint8)
    resolved = np.zeros(size, dtype=bool)
    lit = np.frombuffer(literals, dtype=np.uint8)
    at = np.concatenate([_ranges(starts, ll), np.arange(size - len(lit) + literal_count, size)])
    values[at] = lit
    resolved[at] = True
    pending = _ranges(match_starts, ml)
    source = np.empty(size, dtype=np.int64)  # absolute positions
    source[pending] = pending + base - np.repeat(distance, ml)
    where = source[pending]
    while pending.size:
        earlier = where < base
        if earlier.any():
            low = int(where[earlier].min())
            window = np.frombuffer(bytes(out[low:base]), dtype=np.uint8)
            values[pending[earlier]] = window[where[earlier] - low]
            resolved[pending[earlier]] = True
            pending, where = pending[~earlier], where[~earlier]
        local = where - base
        ready = resolved[local]
        values[pending[ready]] = values[local[ready]]
        resolved[pending[ready]] = True
        pending, local = pending[~ready], local[~ready]
        where = source[local]
        source[pending] = where
    out += values.tobytes()


# ---------------------------------------------------------------- blocks ----

def _literals(state: _FrameState, block: bytes) -> Tuple[bytes, int]:
    """The literals section at the start of a compressed block:
    ``(literals, bytes_used)``."""
    kind = block[0] & 3
    size_format = (block[0] >> 2) & 3
    if kind in (0, 1):
        if size_format in (0, 2):
            header, regenerated = 1, block[0] >> 3
        elif size_format == 1:
            header, regenerated = 2, (block[0] >> 4) + (block[1] << 4)
        else:
            header, regenerated = 3, (block[0] >> 4) + (block[1] << 4) + (block[2] << 12)
        if kind == 0:
            literals = block[header:header + regenerated]
            if len(literals) != regenerated:
                raise ZstdError("raw literals past the block's end")
            return bytes(literals), header + regenerated
        return bytes(block[header:header + 1]) * regenerated, header + 1
    header, width = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[size_format]
    fields = _read_varsize_le(block, 0, header) >> 4
    regenerated = fields & ((1 << width) - 1)
    compressed = fields >> width
    streams = 1 if size_format == 0 else 4
    body = block[header:header + compressed]
    if len(body) != compressed:
        raise ZstdError("compressed literals past the block's end")
    used = 0
    if kind == 2:
        state.huffman, used = _HuffmanTable.read(body, 0)
    elif state.huffman is None:
        raise ZstdError("treeless literals with no Huffman tree before them")
    table = state.huffman
    body = body[used:]
    if streams == 1:
        literals = table.decode_stream(body, regenerated)
    else:
        sizes = struct.unpack_from("<3H", body, 0)
        last = len(body) - 6 - sum(sizes)
        if last < 0:
            raise ZstdError("Huffman jump table past the literals' end")
        quarter = (regenerated + 3) // 4
        counts = [quarter] * 3 + [regenerated - 3 * quarter]
        edges = np.cumsum([6, *sizes, last])
        literals = b"".join(table.decode_stream(bytes(body[a:b]), n)
                            for a, b, n in zip(edges[:-1], edges[1:], counts))
    if len(literals) != regenerated:
        raise ZstdError("Huffman literals of the wrong size")
    return literals, header + compressed


def _compressed_block(state: _FrameState, block: bytes, out: bytearray) -> None:
    literals, offset = _literals(state, block)
    first = block[offset]
    if first == 0:
        count, offset = 0, offset + 1
    elif first < 128:
        count, offset = first, offset + 1
    elif first < 255:
        count, offset = ((first - 128) << 8) + block[offset + 1], offset + 2
    else:
        count, offset = block[offset + 1] + (block[offset + 2] << 8) + 0x7F00, offset + 3
    if count == 0:
        if offset != len(block):
            raise ZstdError("bytes after a block with no sequences")
        out += literals
        return
    modes = block[offset]
    offset += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence compression modes")
    for kind, shift in zip(_KINDS, (6, 4, 2)):
        offset += _sequence_table(state, kind, (modes >> shift) & 3, block, offset)
    _execute(literals, *_decode_sequences(state, bytes(block[offset:]), count), out)


# ----------------------------------------------------------------- XXH64 ----

_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``: the hash zstd's content checksum takes the low 32 bits of."""
    length = len(data)
    offset = 0
    if length >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        stripes = length // 32
        lanes = struct.unpack_from(f"<{4 * stripes}Q", data, 0)
        for i in range(0, 4 * stripes, 4):
            v = [_round(v[0], lanes[i]), _round(v[1], lanes[i + 1]),
                 _round(v[2], lanes[i + 2]), _round(v[3], lanes[i + 3])]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for lane in v:
            h = ((h ^ _round(0, lane)) * _P1 + _P4) & _M64
        offset = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + length) & _M64
    while offset + 8 <= length:
        (lane,) = struct.unpack_from("<Q", data, offset)
        h = (_rotl(h ^ _round(0, lane), 27) * _P1 + _P4) & _M64
        offset += 8
    if offset + 4 <= length:
        (word,) = struct.unpack_from("<I", data, offset)
        h = (_rotl(h ^ (word * _P1 & _M64), 23) * _P2 + _P3) & _M64
        offset += 4
    while offset < length:
        h = (_rotl(h ^ (data[offset] * _P5 & _M64), 11) * _P1) & _M64
        offset += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------- frames ----

def _frame(data: bytes, offset: int, out: bytearray) -> int:
    """Decode the frame at ``data[offset:]`` (after its magic) onto ``out``;
    returns the offset after it."""
    descriptor = data[offset]
    offset += 1
    size_flag, single_segment = descriptor >> 6, (descriptor >> 5) & 1
    has_checksum, dictionary_flag = (descriptor >> 2) & 1, descriptor & 3
    if descriptor & 8:
        raise ZstdError("reserved bit set in the frame header")
    if not single_segment:
        offset += 1  # the window descriptor: every match is checked against the output
    dictionary_bytes = (0, 1, 2, 4)[dictionary_flag]
    dictionary_id = _read_varsize_le(data, offset, dictionary_bytes)
    offset += dictionary_bytes
    if dictionary_id:
        raise FormatNotRead(f"zstd frame needs dictionary {dictionary_id}: "
                            "dictionaries are not read")
    size_bytes = (1 if single_segment else 0, 2, 4, 8)[size_flag]
    content_size = _read_varsize_le(data, offset, size_bytes) if size_bytes else None
    if size_bytes == 2:
        content_size += 256
    offset += size_bytes
    state = _FrameState()
    frame = bytearray()
    while True:
        if offset + 3 > len(data):
            raise ZstdError("frame truncated before a block header")
        header = _read_varsize_le(data, offset, 3)
        offset += 3
        last, kind, size = header & 1, (header >> 1) & 3, header >> 3
        if kind == 1:
            if offset + 1 > len(data):
                raise ZstdError("RLE block truncated")
            frame += data[offset:offset + 1] * size
            offset += 1
        else:
            block = data[offset:offset + size]
            if len(block) != size:
                raise ZstdError("block truncated")
            if kind == 0:
                frame += block
            elif kind == 2:
                if size > MAX_BLOCK_SIZE:
                    raise ZstdError("compressed block above 128 KiB")
                _compressed_block(state, block, frame)
            else:
                raise ZstdError("reserved block type")
            offset += size
        if last:
            break
    if content_size is not None and len(frame) != content_size:
        raise ZstdError(f"frame decoded to {len(frame)} bytes, its header says {content_size}")
    if has_checksum:
        if offset + 4 > len(data):
            raise ZstdError("content checksum truncated")
        (stored,) = struct.unpack_from("<I", data, offset)
        offset += 4
        if xxh64(bytes(frame)) & 0xFFFFFFFF != stored:
            raise ZstdError("content checksum mismatch")
    out += frame
    return offset


def decompress(data: bytes) -> bytes:
    """The content of every frame in ``data``, concatenated."""
    data = bytes(data)
    out = bytearray()
    offset = 0
    while offset < len(data):
        if offset + 4 > len(data):
            raise ZstdError("truncated frame magic")
        (magic,) = struct.unpack_from("<I", data, offset)
        offset += 4
        if magic & SKIPPABLE_MAGIC_MASK == SKIPPABLE_MAGIC:
            (size,) = struct.unpack_from("<I", data, offset)
            offset += 4 + size
            if offset > len(data):
                raise ZstdError("skippable frame truncated")
        elif magic == ZSTD_MAGIC:
            offset = _frame(data, offset, out)
        else:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
    return bytes(out)


def encode(data) -> bytes:
    """A zstd frame that stores ``data`` in raw blocks of at most 128 KiB,
    its content size in the header and no checksum. Up to 128 KiB the frame
    is a single segment (its window is its content); above, the window is
    128 KiB, as no block refers back to another."""
    data = memoryview(data).cast("B")
    size = len(data)
    single_segment = size <= MAX_BLOCK_SIZE
    if size < 256 and single_segment:
        size_flag, size_field = 0, size.to_bytes(1, "little")
    elif size < 256 + (1 << 16):
        size_flag, size_field = 1, (size - 256).to_bytes(2, "little")
    elif size < 1 << 32:
        size_flag, size_field = 2, size.to_bytes(4, "little")
    else:
        size_flag, size_field = 3, size.to_bytes(8, "little")
    header = struct.pack("<IB", ZSTD_MAGIC, size_flag << 6 | single_segment << 5)
    if not single_segment:
        header += bytes([(17 - 10) << 3])  # the window: exponent 7, mantissa 0, 2**17 bytes
    pieces = [header, size_field]
    for start in range(0, max(size, 1), MAX_BLOCK_SIZE):
        block = data[start:start + MAX_BLOCK_SIZE]
        last = start + MAX_BLOCK_SIZE >= size
        pieces += [(len(block) << 3 | last).to_bytes(3, "little"), block]
    return b"".join(pieces)
