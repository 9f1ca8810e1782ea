"""Record format: variable-length int32 token sequences.

Records play the role of the paper's "data files": variable-sized blobs
(token sequences here; image bytes there). A record is raw little-endian
int32 tokens — size in bytes is 4 × length, so the variable-size property
the paper's dynamic allocation exploits is preserved.
"""

from __future__ import annotations

import numpy as np

__all__ = ["encode_record", "decode_record"]


def encode_record(tokens: np.ndarray) -> bytes:
    tokens = np.asarray(tokens, dtype=np.int32)
    return tokens.tobytes()


def decode_record(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype=np.int32)
