"""The port's msgpack codec (``repro_torch.core.wire``) against msgpack: the
same bytes as ``msgpack.packb(obj, use_bin_type=True)`` and the same values
as ``msgpack.unpackb(raw=False, strict_map_key=False)``, exactly, for the
protocol's subset and at every length and integer-width boundary."""
import math

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import wire


def _ref_pack(obj):
    return msgpack.packb(obj, use_bin_type=True)


def _ref_unpack(data):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


def _same(obj):
    data = wire.packb(obj)
    assert data == _ref_pack(obj)
    got = wire.unpackb(data)
    want = _ref_unpack(data)
    assert got == want or (isinstance(want, float) and math.isnan(want) and math.isnan(got))
    assert type(got) is type(want)
    return got


scalars = (st.none() | st.booleans()
           | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
keys = st.text(max_size=12) | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
protocol = st.recursive(
    scalars,
    lambda inner: (st.lists(inner, max_size=20) | st.tuples(inner, inner)
                   | st.dictionaries(keys, inner, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(protocol)
def test_nested_values_pack_like_msgpack(obj):
    _same(obj)


INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]


@pytest.mark.parametrize("n", INT_EDGES)
def test_integer_widths(n):
    assert _same(n) == n


# fixstr < 32 <= str8 < 256 <= str16 < 65536 <= str32; bin8/16/32 likewise
LEN_EDGES = [0, 1, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("n", LEN_EDGES)
def test_str_and_bin_lengths(n):
    assert _same("s" * n) == "s" * n
    assert _same(b"\x01" * n) == b"\x01" * n
    assert _same(bytearray(n)) == bytes(n)
    assert _same(memoryview(b"m" * n)) == b"m" * n
    assert _same("é" * n) == "é" * n          # two bytes per char: length is bytes


# fixarray/fixmap < 16 <= array16/map16 < 65536 <= array32/map32
@pytest.mark.parametrize("n", [0, 15, 16, 65535, 65536])
def test_array_and_map_lengths(n):
    assert _same(list(range(n))) == list(range(n))
    assert _same({i: None for i in range(n)}) == {i: None for i in range(n)}


def test_protocol_frames_and_floats():
    frame = {"op": "open", "framework": "repro-torch", "name": "A", "version": "1",
             "ctx": {"tenant": "t", "deadline_s": 0.25, "priority": -3},
             "tensors": [{"name": "embed", "dtype": "bfloat16", "shape": [102400, 4096],
                          "segment": 0, "offset": 2 ** 33}], "ok": True, "none": None}
    assert _same(frame) == frame
    for x in (0.0, -0.0, 1e-310, 1.5, float("inf"), float("-inf"), float("nan")):
        _same(x)
    # float32 on the wire decodes to the same Python float as msgpack's
    single = msgpack.packb(1.1, use_single_float=True)
    assert wire.unpackb(single) == _ref_unpack(single)


def test_outside_the_subset_raises_as_msgpack_does():
    import numpy as np
    for bad in (object(), {1, 2}, np.int64(3), complex(1, 2)):
        with pytest.raises(TypeError):
            _ref_pack(bad)
        with pytest.raises(TypeError):
            wire.packb(bad)
    for big in (2 ** 64, -2 ** 63 - 1):
        with pytest.raises(OverflowError):
            wire.packb(big)
    ext = msgpack.packb(msgpack.ExtType(1, b"x"))
    with pytest.raises(ValueError):
        wire.unpackb(ext)
    with pytest.raises(ValueError):
        wire.unpackb(_ref_pack([1, 2])[:-1])           # truncated
    with pytest.raises(ValueError):
        wire.unpackb(_ref_pack(1) + b"\x01")           # extra data
