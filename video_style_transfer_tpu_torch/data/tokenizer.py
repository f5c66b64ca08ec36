"""Self-contained CLIP BPE tokenizer on the standard library.

Needs only a ``vocab.json`` and a ``merges.txt`` (the files of a
transformers CLIPTokenizer). SDXL usage: tokenizer 1 pads with its EOS
id, tokenizer 2 pads with 0.

The pre-tokenizer is CLIP's pattern

    <|startoftext|> | <|endoftext|> | 's | 't | 're | 've | 'm | 'll | 'd
    | letters+ | one number character | (not space, letter, number)+

matched case-insensitively, written as a scanner over
``unicodedata.category`` (the standard ``re`` has no ``\\p{L}`` /
``\\p{N}`` classes).
"""
from __future__ import annotations

import functools
import html
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# the one non-ASCII character that case-insensitive matching equates
# with a letter of the literal alternatives: LATIN SMALL LETTER LONG S
_FOLD = {"ſ": "s"}
# the Unicode White_Space property, which is what ``\s`` means in CLIP's
# pattern (str.isspace() also accepts U+001C..U+001F)
_WHITESPACE = frozenset(
    [chr(c) for c in range(0x09, 0x0E)] + [chr(c) for c in range(0x2000,
                                                                  0x200B)]
    + list(" \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"))


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _kind(ch: str) -> str:
    """"L" letter, "N" number, "S" whitespace, "O" anything else."""
    cat = unicodedata.category(ch)[0]
    if cat in "LN":
        return cat
    return "S" if ch in _WHITESPACE else "O"


def _literal_at(text: str, i: int, literals) -> Optional[str]:
    """The first of `literals` that matches text at i, ignoring case;
    returns the matched substring of text."""
    for lit in literals:
        seg = text[i:i + len(lit)]
        if len(seg) == len(lit) and all(
                _FOLD.get(a, a) == b for a, b in zip(seg.lower(), lit)):
            return seg
    return None


def pre_tokenize(text: str) -> List[str]:
    """Split text as CLIP's pattern does (leftmost alternative first,
    each class greedy; whitespace separates and is dropped)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        seg = None
        if ch == "<":
            seg = _literal_at(text, i, _SPECIALS)
        elif ch == "'":
            seg = _literal_at(text, i, _CONTRACTIONS)
        if seg is not None:
            out.append(seg)
            i += len(seg)
            continue
        kind = _kind(ch)
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":   # a number character stands alone
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """Byte-level BPE with '</w>' word terminals (the CLIP flavour)."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 *, bos_token: str = "<|startoftext|>",
                 eos_token: str = "<|endoftext|>",
                 pad_token_id: Optional[int] = None,
                 model_max_length: int = 77):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = vocab[bos_token]
        self.eos_token_id = vocab[eos_token]
        self.pad_token_id = (pad_token_id if pad_token_id is not None
                             else self.eos_token_id)
        self.model_max_length = model_max_length
        self.cache = {bos_token: bos_token, eos_token: eos_token}

    @classmethod
    def from_dir(cls, path: str, **kw) -> "CLIPTokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f.read().split("\n"):
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
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
        self.cache[token] = out
        return out

    def _tokenize(self, text: str) -> List[int]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for token in pre_tokenize(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts, *, max_length: Optional[int] = None,
                 padding: str = "max_length",
                 truncation: bool = True) -> np.ndarray:
        """texts: str or list -> (B, max_length) int64 ids with BOS, EOS
        and padding, as transformers' CLIPTokenizer gives them."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        rows = []
        for text in texts:
            ids = self._tokenize(text)
            if truncation:
                ids = ids[: max_length - 2]
            rows.append([self.bos_token_id] + ids + [self.eos_token_id])
        longest = max(len(r) for r in rows)
        if padding in ("longest", "do_not_pad") or padding is False:
            width = longest
        else:
            width = max_length
            if longest > max_length:
                raise ValueError(
                    f"sequence of length {longest} exceeds max_length="
                    f"{max_length} with truncation=False and "
                    f"padding='max_length'; pass truncation=True or "
                    f"padding='longest'")
        out = np.full((len(rows), width), self.pad_token_id, np.int64)
        for i, row in enumerate(rows):
            out[i, : len(row)] = row
        return out

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) in self.decoder)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")
