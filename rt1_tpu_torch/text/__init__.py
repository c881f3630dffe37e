"""Text tokenization (the port's copy of `rt1_tpu/text/`)."""

from rt1_tpu_torch.text.clip_bpe import (
    CLIP_CONTEXT_LENGTH,
    CLIP_VOCAB_SIZE,
    ClipBPETokenizer,
    bytes_to_unicode,
    default_tokenizer,
)

__all__ = [
    "CLIP_CONTEXT_LENGTH",
    "CLIP_VOCAB_SIZE",
    "ClipBPETokenizer",
    "bytes_to_unicode",
    "default_tokenizer",
]
