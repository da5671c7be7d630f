"""Streaming codecs for compressed blob transfer (DESIGN.md §4, §6).

The CLOUD and peer links are bandwidth-bound, so storing blobs compressed
turns ratio directly into wire seconds saved — as long as decompression is
a *pipeline stage* that overlaps the transfer rather than a serial epilogue
(the decompress-stage model in `costmodel`). This module is the small codec
abstraction both sides of that pipeline share: a :class:`Codec` names the
format and hands out *streaming* compressor/decompressor objects so chunks
can flow through `run_pipeline` one at a time with bounded memory.

Codecs are addressed by name (``"none" | "zlib" | "lzma"``) because the
name is what the ObjectStore manifest records per blob — a fetch must be
able to decode blobs written by any earlier configuration.
"""
from __future__ import annotations

import lzma
import zlib
from typing import Dict, Optional, Union


class _NullStream:
    """Identity (de)compressor: the ``none`` codec's streaming object."""

    def compress(self, data: bytes) -> bytes:
        return bytes(data)

    decompress = compress

    def flush(self) -> bytes:
        return b""


class _LzmaDecompressorAdapter:
    """lzma's decompressor lacks ``flush()``; adapt to the zlib protocol."""

    def __init__(self):
        self._d = lzma.LZMADecompressor()

    def decompress(self, data: bytes) -> bytes:
        if not data:
            return b""
        return self._d.decompress(data)

    def flush(self) -> bytes:
        return b""


class Codec:
    """One compression format: streaming factories + one-shot helpers.

    ``compressor()``/``decompressor()`` return objects with the zlib
    protocol — ``compress(b)``/``decompress(b)`` per chunk plus a final
    ``flush()`` — which is what the chunked transfer pipelines consume.
    A compressor/decompressor pair is single-stream state: create a fresh
    one per transfer, and feed it from exactly one pipeline stage thread.
    """

    name = "none"

    def compressor(self):
        return _NullStream()

    def decompressor(self):
        return _NullStream()

    # -- one-shot convenience (tests, ratio sampling) ------------------------
    def compress(self, data: bytes) -> bytes:
        c = self.compressor()
        return c.compress(data) + c.flush()

    def decompress(self, data: bytes) -> bytes:
        d = self.decompressor()
        return d.decompress(data) + d.flush()


class ZlibCodec(Codec):
    """DEFLATE — the throughput-oriented default for blob storage."""

    name = "zlib"

    def __init__(self, level: int = 6):
        self.level = level

    def compressor(self):
        return zlib.compressobj(self.level)

    def decompressor(self):
        return zlib.decompressobj()


class LzmaCodec(Codec):
    """LZMA at a fast preset — higher ratio, slower than zlib; the point on
    the ratio/decompress-rate tradeoff where decode becomes the max-stage
    sooner (DESIGN.md §4 crossover)."""

    name = "lzma"

    def __init__(self, preset: int = 1):
        self.preset = preset

    def compressor(self):
        return lzma.LZMACompressor(preset=self.preset)

    def decompressor(self):
        return _LzmaDecompressorAdapter()


CODECS: Dict[str, Codec] = {c.name: c for c in (Codec(), ZlibCodec(),
                                                LzmaCodec())}


def get_codec(name: Optional[Union[str, Codec]]) -> Codec:
    """Resolve a codec by name (None means ``none``); Codec instances pass
    through, so callers can inject a tuned level/preset."""
    if isinstance(name, Codec):
        return name
    if name is None:
        return CODECS["none"]
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; have {sorted(CODECS)}")


def sample_ratio(path: str, codec: Union[str, Codec],
                 sample_bytes: int = 1 << 20) -> float:
    """Cheap compression-ratio estimate: compress the file's first
    ``sample_bytes`` and extrapolate. Used for fetch-source cost compares
    when no manifest records the real stored size; clamped to >= 1.0 so an
    incompressible sample never *inflates* a modeled wire leg."""
    c = get_codec(codec)
    if c.name == "none":
        return 1.0
    with open(path, "rb") as f:
        raw = f.read(sample_bytes)
    if not raw:
        return 1.0
    return max(1.0, len(raw) / max(1, len(c.compress(raw))))
