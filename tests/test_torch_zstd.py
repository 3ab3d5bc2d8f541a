"""The port's Zstandard decoder (`vlsa_tpu_torch/utils/zstd.py`) against the
`zstandard` module, bit for bit.

Inputs from 0 bytes to several MB (random bytes, f32 weight-like arrays,
runs of zeros, text, a mix) at levels 1, 3 and 19, with and without a
checksum and a content size; frames of several blocks, concatenated
frames, skippable frames, frames the streaming compressor writes (no
content size, several blocks); every zstd frame of the committed orbax
fixtures (each OCDBT node and each zarr chunk); hypothesis-drawn inputs
and levels; and corrupt or truncated frames, which raise ValueError.
"""
import os

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_orbax import FIXTURES
from vlsa_tpu_torch.runner.orbax import read_ocdbt
from vlsa_tpu_torch.utils.zstd import decompress


def _inputs():
    rng = np.random.default_rng(0)
    words = [b"survival ", b"slide ", b"patch ", b"the ", b"of ", b"\n", b"0.25 ", b"hazard "]
    text = b"".join(words[i] for i in rng.integers(0, len(words), 60000))
    return {
        "empty": b"",
        "one": b"x",
        "random_1k": rng.integers(0, 256, 1000, dtype=np.uint8).tobytes(),
        "random_3m": rng.integers(0, 256, 3_000_000, dtype=np.uint8).tobytes(),
        "weights_f32": (rng.standard_normal(700_000) * 0.02).astype(np.float32).tobytes(),
        "zeros_2m": bytes(2 << 20),
        "text": text,
        "mixed": b"".join(bytes(int(n)) + rng.integers(0, 256, int(m), dtype=np.uint8).tobytes()
                          + text[:int(k)] for n, m, k in rng.integers(0, 3000, (60, 3))),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decodes_what_zstandard_writes(name, level):
    data = INPUTS[name]
    if level == 19 and len(data) > 1_000_000:
        data = data[:1_000_000]  # level 19 takes seconds a MB to compress
    for checksum in (False, True):
        for size in (True, False):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                             write_content_size=size).compress(data)
            assert decompress(frame) == data, (name, level, checksum, size)


def test_streamed_frames_of_many_blocks_and_concatenated_frames():
    """The streaming compressor writes no content size and a block per
    flush; frames joined back to back, and a skippable frame between them,
    decode to the joined contents."""
    parts = [INPUTS["text"][:200_000], INPUTS["weights_f32"][:300_000], INPUTS["zeros_2m"][:10]]
    cctx = zstandard.ZstdCompressor(level=3, write_checksum=True)
    chunks = []
    obj = cctx.compressobj()
    for i in range(0, len(parts[0]), 7000):
        chunks.append(obj.compress(parts[0][i:i + 7000]))
        chunks.append(obj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK))
    chunks.append(obj.flush())
    streamed = b"".join(chunks)
    assert decompress(streamed) == parts[0]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"skip!"
    joined = streamed + skippable + cctx.compress(parts[1]) + cctx.compress(parts[2])
    assert decompress(joined) == b"".join(parts)


def _ocdbt_frames():
    """Every zstd frame of the committed orbax fixtures: the compressed body
    of each OCDBT manifest and node (the d/ data files hold nodes one after
    another), and each zarr chunk."""
    frames = []
    for d, subdirs, files in os.walk(FIXTURES):
        if d.endswith(".orbax"):
            frames += [v for k, v in sorted(read_ocdbt(d).items()) if not k.endswith("/.zarray")]
        if ".orbax" not in d:
            continue
        for f in files:
            blob = open(os.path.join(d, f), "rb").read()
            at = 0
            while at + 14 <= len(blob) and blob[at:at + 2] == b"\x0c\xdb":
                n = int.from_bytes(blob[at + 4:at + 12], "little")
                if blob[at + 13] == 1:
                    frames.append(blob[at + 14:at + n - 4])
                at += n
    return frames


def test_every_frame_of_the_fixtures():
    frames = _ocdbt_frames()
    assert len(frames) > 30
    dctx = zstandard.ZstdDecompressor()
    for frame in frames:
        assert frame[:4] == b"\x28\xb5\x2f\xfd"
        assert decompress(frame) == dctx.decompressobj().decompress(frame)


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=5000), level=st.integers(1, 19), repeat=st.integers(1, 40),
       checksum=st.booleans())
def test_hypothesis_inputs(data, level, repeat, checksum):
    payload = data * repeat + data[: len(data) // 2]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(payload)
    assert decompress(frame) == payload


def _corruptions():
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(INPUTS["text"])
    raw = zstandard.ZstdCompressor(level=3).compress(INPUTS["text"])
    flipped = bytearray(frame)
    flipped[len(frame) // 2] ^= 0x40
    bad_sum = bytearray(frame)
    bad_sum[-1] ^= 1
    return {"truncated": frame[: len(frame) // 2], "one_byte_short": raw[:-1],
            "no_magic": b"\x00" + frame[1:], "bad_checksum": bytes(bad_sum),
            "flipped": bytes(flipped), "empty": b"", "magic_only": frame[:4],
            # a single-segment frame of 5 bytes whose one block is of the reserved type
            "reserved_block": (bytes.fromhex("28b52ffd") + bytes([0x20, 5])
                               + (1 | 3 << 1 | 5 << 3).to_bytes(3, "little") + b"abcde"),
            "dictionary": (bytes.fromhex("28b52ffd") + bytes([0x01]) + b"\x07"
                           + b"\x01\x00\x00")}


@pytest.mark.parametrize("name", sorted(_corruptions()))
def test_a_corrupt_or_truncated_frame_raises(name):
    with pytest.raises(ValueError):
        decompress(_corruptions()[name])
