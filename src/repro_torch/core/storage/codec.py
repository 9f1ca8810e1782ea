"""Chunk codecs + the framed progressive record container (DESIGN.md §15).

The chunk layout in ``store.py`` is byte-oriented: a chunk file is the
concatenation of its member records and the sidecar index holds *logical*
offsets. This module changes only the byte representation on disk — never
the redirection protocol or the exactly-once semantics:

* **Codecs** (:data:`CODECS`) turn a buffer into a smaller buffer and back.
  ``none`` is the identity, ``zlib`` is the stdlib DEFLATE, and ``lz4`` is a
  self-contained LZ4-style LZ77 token format (literal-run/match sequences,
  no entropy coder) so the fast-codec path needs no third-party wheel.
* **Frames** wrap one chunk: a small header naming the codec plus one or
  more independently-compressed *fidelity bands*.
* **Bands** make records progressive (Progressive Compressed Records):
  band ``b`` of a chunk holds, for every record, the slice of its tokens
  between the record's band-``b`` cut points. Decoding bands ``0..k-1``
  and re-concatenating per record yields, for every record, a strict
  token-prefix of the full record — so an I/O-bound job can train on
  truncated records while a compute-bound job decodes everything.

Cut points are derived purely from the logical record sizes already in the
offset index, so bands need no extra per-record metadata on disk.
"""

from __future__ import annotations

import struct
import zlib

__all__ = [
    "CODECS",
    "Codec",
    "ChunkFrame",
    "FRAME_MAGIC",
    "band_cuts",
    "encode_frame",
    "get_codec",
    "is_frame",
    "parse_frame",
    "peek_frame",
]

FRAME_MAGIC = b"RXF1"
_FRAME_VERSION = 1
# Longest prefix peek_frame() ever needs: magic + version + nbands +
# name length + a 255-byte codec name.
FRAME_PEEK_BYTES = 4 + 3 + 255


# ------------------------------------------------------------------ codecs
class Codec:
    """One reversible byte transform. Stateless; instances live in CODECS."""

    name: str = "abstract"

    def encode(self, data: "bytes | memoryview", level: int = -1) -> bytes:
        raise NotImplementedError

    def decode(self, data: "bytes | memoryview") -> bytes:
        raise NotImplementedError


class NoneCodec(Codec):
    """Identity codec: framed (banded) layout without compression."""

    name = "none"

    def encode(self, data, level=-1) -> bytes:
        return bytes(data)

    def decode(self, data) -> bytes:
        return bytes(data)


class ZlibCodec(Codec):
    """Stdlib DEFLATE. ``level`` is the zlib level (-1 = library default)."""

    name = "zlib"

    def encode(self, data, level=-1) -> bytes:
        return zlib.compress(bytes(data), level)

    def decode(self, data) -> bytes:
        return zlib.decompress(data)


class Lz4Codec(Codec):
    """LZ4-style LZ77 block codec, implemented in-repo.

    Sequence format (mirrors the LZ4 block spirit): a token byte packs
    ``(literal_len << 4) | (match_len - 4)`` with 255-chunk extension
    bytes for either nibble at 15, followed by the literals, a 16-bit
    little-endian match offset, and the match-length extensions. The last
    sequence carries literals only (decode stops at end of input).
    ``level`` is accepted for registry uniformity and ignored.
    """

    name = "lz4"
    _MIN_MATCH = 4
    _MAX_OFFSET = 0xFFFF

    def encode(self, data, level=-1) -> bytes:
        data = bytes(data)
        n = len(data)
        out = bytearray()
        table: dict[bytes, int] = {}
        anchor = 0
        pos = 0
        limit = n - self._MIN_MATCH
        while pos <= limit:
            key = data[pos : pos + 4]
            ref = table.get(key)
            table[key] = pos
            if ref is None or pos - ref > self._MAX_OFFSET:
                pos += 1
                continue
            mlen = 4
            while pos + mlen < n and data[ref + mlen] == data[pos + mlen]:
                mlen += 1
            self._emit(out, data, anchor, pos, pos - ref, mlen)
            pos += mlen
            anchor = pos
        self._emit(out, data, anchor, n, 0, 0)  # final literal-only run
        return bytes(out)

    @staticmethod
    def _emit(out: bytearray, data: bytes, lit_start: int, lit_end: int,
              offset: int, mlen: int) -> None:
        lit = lit_end - lit_start
        mtok = 0 if mlen == 0 else mlen - 4
        out.append((min(lit, 15) << 4) | min(mtok, 15))
        if lit >= 15:
            rest = lit - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)
        out += data[lit_start:lit_end]
        if mlen == 0:
            return  # final sequence: literals only
        out += struct.pack("<H", offset)
        if mtok >= 15:
            rest = mtok - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)

    def decode(self, data) -> bytes:
        data = bytes(data)
        out = bytearray()
        pos, n = 0, len(data)
        while pos < n:
            token = data[pos]
            pos += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    b = data[pos]
                    pos += 1
                    lit += b
                    if b != 255:
                        break
            out += data[pos : pos + lit]
            pos += lit
            if pos >= n:
                break  # final literal-only sequence
            offset = data[pos] | (data[pos + 1] << 8)
            pos += 2
            mlen = (token & 0xF) + 4
            if (token & 0xF) == 15:
                while True:
                    b = data[pos]
                    pos += 1
                    mlen += b
                    if b != 255:
                        break
            start = len(out) - offset
            if offset >= mlen:
                out += out[start : start + mlen]
            else:  # overlapping match = run-length copy
                for i in range(mlen):
                    out.append(out[start + i])
        return bytes(out)


CODECS: "dict[str, Codec]" = {
    c.name: c for c in (NoneCodec(), ZlibCodec(), Lz4Codec())
}


def get_codec(name: str) -> Codec:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; expected one of {sorted(CODECS)}"
        ) from None


# ------------------------------------------------------------------- bands
def band_cuts(nbytes: int, bands: int) -> "list[int]":
    """Byte cut points ``[c_0=0, ..., c_bands=nbytes]`` for one record.

    Cuts land on token (4-byte) boundaries whenever the record is a whole
    number of int32 tokens, so every band prefix stays decodable by
    ``decode_record``; odd-sized blobs fall back to plain byte cuts.
    """
    item = 4 if nbytes % 4 == 0 else 1
    n = nbytes // item
    return [(n * b // bands) * item for b in range(bands)] + [nbytes]


# ------------------------------------------------------------------ frames
class ChunkFrame:
    """A parsed (not yet decompressed) chunk frame.

    ``raw_bands`` holds the compressed band payloads — this is the object
    :class:`~repro.service.SharedResidency` caches, so its footprint is
    the *physical* (compressed) bytes. ``decoded`` is an optional eager
    decode filled on a backend worker thread and consumed exactly once by
    the first claim via :meth:`take_decoded`; per-claim decodes afterwards
    call :meth:`decode_bands`, which never mutates the frame.
    """

    __slots__ = ("codec_name", "raw_bands", "physical_bytes", "decoded")

    def __init__(self, codec_name: str, raw_bands: "tuple", physical_bytes: int):
        self.codec_name = codec_name
        self.raw_bands = raw_bands
        self.physical_bytes = int(physical_bytes)
        self.decoded: "list[bytes] | None" = None

    @property
    def nbands(self) -> int:
        return len(self.raw_bands)

    def decode_bands(self, fidelity: "int | None" = None) -> "list[bytes]":
        """Decompress bands ``0..fidelity-1`` into fresh buffers."""
        f = self.nbands if fidelity is None else max(1, min(fidelity, self.nbands))
        codec = get_codec(self.codec_name)
        return [codec.decode(self.raw_bands[b]) for b in range(f)]

    def ensure_decoded(self, fidelity: "int | None" = None) -> "list[bytes]":
        """Eager decode hook (runs on the ParallelBackend worker thread)."""
        out = self.decode_bands(fidelity)
        self.decoded = out
        return out

    def take_decoded(self, fidelity: int) -> "list[bytes] | None":
        """Claim the eager decode if it covers ``fidelity`` bands; clears it
        so cached frames hold compressed bytes only."""
        out, self.decoded = self.decoded, None
        if out is not None and len(out) >= fidelity:
            return out[:fidelity]
        return None

    def decoded_nbytes(self) -> int:
        return sum(len(b) for b in self.decoded) if self.decoded else 0


def encode_frame(codec_name: str, band_payloads: "list[bytes]") -> bytes:
    """Serialise one chunk: header + per-band lengths + payloads."""
    name = codec_name.encode("ascii")
    if not 1 <= len(name) <= 255:
        raise ValueError(f"codec name {codec_name!r} out of range")
    if not 1 <= len(band_payloads) <= 255:
        raise ValueError(f"band count {len(band_payloads)} out of range")
    head = bytearray(FRAME_MAGIC)
    head.append(_FRAME_VERSION)
    head.append(len(band_payloads))
    head.append(len(name))
    head += name
    for p in band_payloads:
        head += struct.pack("<I", len(p))
    return bytes(head) + b"".join(band_payloads)


def is_frame(buf: "bytes | memoryview") -> bool:
    return bytes(buf[:4]) == FRAME_MAGIC


def peek_frame(prefix: "bytes | memoryview") -> "tuple[str, int] | None":
    """``(codec_name, nbands)`` from a file prefix, or None if not a frame."""
    prefix = bytes(prefix)
    if len(prefix) < 7 or prefix[:4] != FRAME_MAGIC:
        return None
    nbands, nlen = prefix[5], prefix[6]
    if len(prefix) < 7 + nlen:
        return None
    return prefix[7 : 7 + nlen].decode("ascii"), nbands


def parse_frame(buf: "bytes | memoryview") -> ChunkFrame:
    """Split a frame into compressed band views (no decompression)."""
    mv = memoryview(buf)
    total = mv.nbytes
    if total < 7 or bytes(mv[:4]) != FRAME_MAGIC:
        raise ValueError("not a chunk frame (bad magic)")
    version, nbands, nlen = mv[4], mv[5], mv[6]
    if version != _FRAME_VERSION:
        raise ValueError(f"unsupported frame version {version}")
    pos = 7
    codec_name = bytes(mv[pos : pos + nlen]).decode("ascii")
    pos += nlen
    lens = struct.unpack_from(f"<{nbands}I", mv, pos)
    pos += 4 * nbands
    if pos + sum(lens) != total:
        raise ValueError(
            f"frame length mismatch: header says {pos + sum(lens)}, got {total}"
        )
    bands = []
    for ln in lens:
        bands.append(mv[pos : pos + ln])
        pos += ln
    return ChunkFrame(codec_name, tuple(bands), total)
