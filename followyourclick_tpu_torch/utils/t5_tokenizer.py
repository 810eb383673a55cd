"""The T5 tokenizer of the port: a SentencePiece Unigram model in Python.

The JAX package builds ``tokenizer_2`` with
``transformers.AutoTokenizer.from_pretrained(t5_path)``
(``followyourclick_tpu/utils/loaders.py``). The port tokenizes on its own,
as it does for CLIP, from either file a T5 directory ships:

- ``tokenizer.json`` (preferred): the ``Unigram`` model (pieces, scores,
  ``unk_id``), the normalizer and pre-tokenizer it declares (``Sequence``,
  ``NFKC`` / ``NFC`` / ``NFD`` / ``NFKD``, ``Lowercase``, ``Strip``,
  ``Replace``, ``Prepend``; ``WhitespaceSplit`` and ``Metaspace``), its
  added tokens (split out of the text before normalisation) and the
  ``$A </s>`` template;
- ``spiece.model``: the SentencePiece protobuf (``ModelProto.pieces``, field
  1, each ``piece`` / ``score`` / ``type`` in fields 1 / 2 / 3; the
  normalizer spec, field 3, for ``add_dummy_prefix`` and
  ``remove_extra_whitespaces``), read by a small varint reader.

A ``Precompiled`` normalizer (SentencePiece's character map) is applied as
Unicode NFKC, and ``spiece.model`` is normalised the same way: the map is
NFKC with a few extra rules, which are not decoded.

Encoding is the ``tokenizers`` Unigram's: a Viterbi pass over the pieces of
each pre-token, ties to the earliest candidate, one unknown node of score
``min(score) - 10`` for a character that starts no piece, consecutive
unknowns fused into one. The call returns ``input_ids`` and
``attention_mask`` as int64 numpy, ``</s>`` kept last when a prompt is
truncated and ``<pad>`` after it, as ``T5TokenizerFast`` does.
"""

from __future__ import annotations

import json
import os
import re
import struct
import types
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

SPACE = "▁"
_UNK_PENALTY = 10.0
# SentencePiece piece types (sentencepiece_model.proto)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of one protobuf
    message: an int for varints, bytes for length-delimited fields and the
    raw 4 or 8 bytes of fixed-width ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _normalizer(spec: Optional[dict]):
    """A ``str → str`` function for a ``tokenizer.json`` normalizer."""
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def run(s):
            for p in parts:
                s = p(s)
            return s
        return run
    if kind in ("NFKC", "NFC", "NFD", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Precompiled":
        return lambda s: unicodedata.normalize("NFKC", s)
    if kind == "Lowercase":
        return str.lower
    if kind == "Strip":
        left = spec.get("strip_left", True)
        right = spec.get("strip_right", True)

        def strip(s):
            s = s.lstrip() if left else s
            return s.rstrip() if right else s
        return strip
    if kind == "Replace":
        pattern = spec["pattern"]
        regex = re.compile(pattern["Regex"] if "Regex" in pattern
                           else re.escape(pattern["String"]))
        content = spec["content"]
        return lambda s: regex.sub(lambda _: content, s)
    if kind == "Prepend":
        return lambda s: spec["prepend"] + s if s else s
    raise ValueError(f"unsupported tokenizer.json normalizer {kind!r}")


def _metaspace(spec: dict):
    replacement = spec.get("replacement", SPACE)
    scheme = spec.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    split = spec.get("split", True)

    def run(words: List[Tuple[str, bool]]):
        out = []
        for word, first in words:
            word = word.replace(" ", replacement)
            if (scheme == "always" or (scheme == "first" and first)) \
                    and not word.startswith(replacement):
                word = replacement + word
            if split:
                # MergedWithNext: each replacement character opens a piece
                pieces = re.split(f"(?={re.escape(replacement)})", word)
                out.extend((p, first and i == 0)
                           for i, p in enumerate(pieces) if p)
            else:
                out.append((word, first))
        return out
    return run


def _pre_tokenizer(spec: Optional[dict]):
    """A function from [(text, starts the input)] to pre-tokens."""
    if spec is None:
        return lambda words: words
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(words):
            for p in parts:
                words = p(words)
            return words
        return run
    if kind == "WhitespaceSplit":
        return lambda words: [(w, first and i == 0) for text, first in words
                              for i, w in enumerate(text.split())]
    if kind == "Metaspace":
        return _metaspace(spec)
    raise ValueError(f"unsupported tokenizer.json pre-tokenizer {kind!r}")


class T5Tokenizer:
    """``tokenizer(texts, padding="max_length", max_length=77,
    truncation=True, return_tensors="np")`` → ``input_ids``,
    ``attention_mask``. Build with :meth:`from_pretrained` (a directory,
    or either file)."""

    def __init__(self, pieces: Sequence[Tuple[str, float]], unk_id: int,
                 eos_id: int, pad_id: int, normalize, pre_tokenize,
                 matchable: Optional[Sequence[bool]] = None,
                 added: Optional[Dict[str, int]] = None):
        self.pieces = [p for p, _ in pieces]
        self.scores = [float(s) for _, s in pieces]
        self.unk_id, self.eos_id, self.pad_id = unk_id, eos_id, pad_id
        self.normalize, self.pre_tokenize = normalize, pre_tokenize
        if matchable is None:
            matchable = [True] * len(pieces)
        self.vocab = {p: i for i, (p, ok) in enumerate(zip(self.pieces,
                                                           matchable)) if ok}
        self.max_len = max(len(p) for p in self.vocab)
        self.unk_score = min(self.scores) - _UNK_PENALTY
        self.added = dict(added or {})
        self._added_re = re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True))
        ) if self.added else None

    @classmethod
    def from_pretrained(cls, path: str) -> "T5Tokenizer":
        if os.path.isdir(path):
            for name in ("tokenizer.json", "spiece.model"):
                if os.path.exists(os.path.join(path, name)):
                    path = os.path.join(path, name)
                    break
            else:
                raise FileNotFoundError(
                    f"{path}: no tokenizer.json or spiece.model")
        if path.endswith(".json"):
            return cls.from_tokenizer_json(path)
        return cls.from_spiece_model(path)

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "T5Tokenizer":
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type", "Unigram") != "Unigram":
            raise ValueError(f"{path}: model {model.get('type')!r} is not "
                             "a Unigram model")
        pieces = [(p, s) for p, s in model["vocab"]]
        index = {p: i for i, (p, _) in enumerate(pieces)}
        added = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        # the template's special token closes every sequence ($A </s>)
        post = spec.get("post_processor") or {}
        eos = next(iter(post.get("special_tokens") or {"</s>": None}))
        return cls(pieces, model["unk_id"], added.get(eos, index.get(eos)),
                   added.get("<pad>", index.get("<pad>", 0)),
                   _normalizer(spec.get("normalizer")),
                   _pre_tokenizer(spec.get("pre_tokenizer")), added=added)

    @classmethod
    def from_spiece_model(cls, path: str) -> "T5Tokenizer":
        with open(path, "rb") as f:
            buf = f.read()
        pieces, types_ = [], []
        dummy_prefix = extra_ws = True
        for field, _, value in _fields(buf):
            if field == 1:
                piece, score, kind = "", 0.0, _NORMAL
                for f2, _, v2 in _fields(value):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        kind = v2
                pieces.append((piece, score))
                types_.append(kind)
            elif field == 3:
                for f2, _, v2 in _fields(value):
                    if f2 == 3:
                        dummy_prefix = bool(v2)
                    elif f2 == 4:
                        extra_ws = bool(v2)
        index = {p: i for i, (p, _) in enumerate(pieces)}

        def normalize(s):
            s = unicodedata.normalize("NFKC", s)
            if extra_ws:
                s = re.sub(" +", " ", s.strip(" "))
            return s

        meta = _metaspace({"replacement": SPACE, "split": True,
                           "prepend_scheme": "always" if dummy_prefix
                           else "never"})
        return cls(pieces, types_.index(_UNKNOWN), index["</s>"],
                   index.get("<pad>", 0), normalize, meta,
                   matchable=[t in (_NORMAL, _USER_DEFINED) for t in types_])

    def _viterbi(self, text: str) -> List[int]:
        n = len(text)
        best = [0.0] + [None] * n          # best path score ending at i
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        for start in range(n):
            if best[start] is None:
                continue
            single = False
            for end in range(start + 1, min(n, start + self.max_len) + 1):
                i = self.vocab.get(text[start:end])
                if i is None:
                    continue
                single |= end == start + 1
                score = best[start] + self.scores[i]
                if best[end] is None or score > best[end]:
                    best[end], back[end] = score, (start, i)
            if not single:
                score = best[start] + self.unk_score
                end = start + 1
                if best[end] is None or score > best[end]:
                    best[end], back[end] = score, (start, self.unk_id)
        ids = []
        end = n
        while end > 0:
            start, i = back[end]
            ids.append(i)
            end = start
        ids.reverse()
        fused = []
        for i in ids:
            if not (i == self.unk_id and fused and fused[-1] == self.unk_id):
                fused.append(i)
        return fused

    def encode(self, text: str) -> List[int]:
        """Token ids of ``text`` without ``</s>``."""
        chunks = []
        if self._added_re is not None:
            pos = 0
            for m in self._added_re.finditer(text):
                chunks.append((text[pos:m.start()], None))
                chunks.append((m.group(), self.added[m.group()]))
                pos = m.end()
            chunks.append((text[pos:], None))
        else:
            chunks.append((text, None))
        ids: List[int] = []
        for k, (chunk, added_id) in enumerate(chunks):
            if added_id is not None:
                ids.append(added_id)
                continue
            normal = self.normalize(chunk)
            if not normal:
                continue
            for word, _ in self.pre_tokenize([(normal, k == 0)]):
                ids.extend(self._viterbi(word))
        return ids

    def __call__(self, texts: Union[str, Sequence[str]],
                 padding: Union[str, bool] = "max_length",
                 max_length: int = 77, truncation: bool = True,
                 return_tensors: str = "np"):
        if isinstance(texts, str):
            texts = [texts]
        rows = []
        for text in texts:
            ids = self.encode(text)
            if truncation and len(ids) + 1 > max_length:
                ids = ids[:max_length - 1]
            rows.append(ids + [self.eos_id])
        width = max_length if padding == "max_length" else \
            max(len(r) for r in rows)
        input_ids = np.full((len(rows), width), self.pad_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for r, ids in enumerate(rows):
            if len(ids) > width:
                raise ValueError(f"{len(ids)} tokens do not fit "
                                 f"max_length={max_length} without "
                                 "truncation")
            input_ids[r, :len(ids)] = ids
            mask[r, :len(ids)] = 1
        return types.SimpleNamespace(input_ids=input_ids,
                                     attention_mask=mask)
