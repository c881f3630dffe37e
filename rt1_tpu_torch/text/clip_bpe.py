"""CLIP byte-pair-encoding tokenizer, pure Python (the port's copy of
`rt1_tpu/text/clip_bpe.py`; the port imports nothing of the JAX package).

Parity source: reference `language_table/common/clip_tokenizer.py:42-152` —
OpenAI CLIP's SimpleTokenizer as used to feed the LAVA text tower: the
byte-unicode mapping, greedy lowest-rank BPE merges, `</w>` word terminals,
the CLIP regex split, SOT/EOT framing and a zero-padded 77-token context.

The real CLIP vocabulary (`bpe_simple_vocab_16e6.txt.gz`) is not in the
repository; pass its path to `ClipBPETokenizer.from_bpe_file` when it is.
`default_tokenizer()` is the byte-level tokenizer without merges (vocab
514). Without the `regex` package (absent on some machines) the split
falls back to the stdlib `re` with ASCII classes (`split_pattern`), which
gives the same tokens on ASCII text such as Language-Table's instructions.
"""

import functools
import gzip
import html
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import regex as _re  # Unicode \p{L}/\p{N} classes, like CLIP's regex
except ImportError:  # pragma: no cover - regex ships with transformers
    _re = None

CLIP_VOCAB_SIZE = 49408
CLIP_CONTEXT_LENGTH = 77

# CLIP SimpleTokenizer's split pattern (contractions, letters, digits,
# punctuation runs). With the `regex` module the Unicode property classes
# match CLIP exactly; the stdlib-`re` fallback is ASCII-only (non-Latin
# letters fall into the punctuation class).
_RAW_PATTERN = r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""


def split_pattern(use_regex: bool = True):
    """The compiled split pattern: the `regex` module's Unicode classes when
    it is installed and `use_regex`, else the stdlib ASCII fallback."""
    if use_regex and _re is not None:
        return _re.compile(_RAW_PATTERN, _re.IGNORECASE)
    return re.compile(
        _RAW_PATTERN.replace(r"\p{L}", "a-zA-Z").replace(r"\p{N}", "0-9"),
        re.IGNORECASE,
    )


_PATTERN = split_pattern()


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode mapping (BPE works on these)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ClipBPETokenizer:
    """Greedy lowest-rank BPE with CLIP's word-terminal convention."""

    def __init__(
        self,
        merges: Sequence[Tuple[str, str]],
        context_length: int = CLIP_CONTEXT_LENGTH,
    ):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        # Vocabulary layout matches CLIP exactly: 256 byte symbols, their
        # </w> variants, one entry per merge, then SOT/EOT
        # (reference `create_vocab`, clip_tokenizer.py:117-135).
        vocab: List[str] = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.context_length = context_length
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]
        self._cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    @classmethod
    def from_bpe_file(cls, path: str, **kwargs) -> "ClipBPETokenizer":
        """Load the standard CLIP `bpe_simple_vocab_16e6.txt.gz`."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        merges = lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        return cls(merges, **kwargs)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> BPE token ids (no SOT/EOT framing)."""
        # Cleaning parity with SimpleTokenizer: unescape HTML (the in-graph
        # TF version can't, clip_tokenizer.py:73-76 — we can), collapse
        # whitespace, lowercase.
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids: List[int] = []
        for token in _PATTERN.findall(text):
            token_bytes = "".join(
                self.byte_encoder[b] for b in token.encode("utf-8")
            )
            for piece in self._bpe(token_bytes).split(" "):
                ids.append(self.encoder[piece])
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(
            self.decoder[i]
            for i in ids
            if i not in (self.sot_token, self.eot_token)
        )
        # '</w>' survives byte-decoding (its chars are all in the byte map);
        # swap it for a space afterwards, like CLIP's SimpleTokenizer.decode.
        raw = bytearray(self.byte_decoder[c] for c in text)
        return (
            raw.decode("utf-8", errors="replace")
            .replace("</w>", " ")
            .strip()
        )

    def tokenize_text(
        self, texts, context_length: Optional[int] = None
    ) -> np.ndarray:
        """[str] -> (n, 77) int32, SOT + ids + EOT, zero padded
        (reference `tokenize_text`, clip_tokenizer.py:138-152)."""
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        out = np.zeros((len(texts), context_length), np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(ids) > context_length:
                raise ValueError(
                    f"Input too long ({len(ids)} > {context_length}): "
                    f"{text!r}"
                )
            out[row, : len(ids)] = ids
        return out


def default_tokenizer(context_length: int = CLIP_CONTEXT_LENGTH) -> ClipBPETokenizer:
    """Byte-level CLIP tokenizer (no merges): 514-entry vocab of byte symbols
    + SOT/EOT, every word split into its byte</w> sequence.

    This is the zero-asset fallback — the exact CLIP framing and special
    tokens, but each character costs one token, so only short instructions
    fit in 77 (Language-Table's longest grammar strings do). For parity with
    public CLIP checkpoints load the real merges via `from_bpe_file`.
    """
    return ClipBPETokenizer(merges=[], context_length=context_length)
