from .tokens import decode_record, encode_record
from .synthetic import SyntheticTokenDataset, paper_like_sizes

__all__ = [
    "decode_record",
    "encode_record",
    "SyntheticTokenDataset",
    "paper_like_sizes",
]
